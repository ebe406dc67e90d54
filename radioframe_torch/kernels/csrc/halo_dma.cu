// K7: ring halo exchange through device memory, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/halo_dma.py::_halo_kernel
// (driven by ring_halo_dma / causal_halo_dma): every shard of the time axis
// sends the last H samples of each channel to its right neighbour, which
// thereby receives its causal halo. The TPU kernel starts a remote DMA with
// send/recv semaphores. Here the ranks are processes, each owning one
// receive buffer made with cudaMalloc (a dedicated allocation, so that its
// IPC handle's offset is 0); each rank maps its right neighbour's buffer
// with cudaIpcOpenMemHandle (the same card, or a peer card).
//
// Buffer: two u64 sequence flags (padded to 256 bytes), then two payload
// slots of C x Hf float words (complex samples travel as float pairs, the
// reference's contract). Call s uses slot and flag s & 1, so a neighbour
// one call ahead never overwrites a slot that is still being read.
//
//   * put  (one block): copy the local tail words into the neighbour's slot,
//     fence at system scope, then store s into the neighbour's flag with
//     release semantics.
//   * The host waits for the put (an event), then meets every rank of the
//     axis at a barrier: after it, every put of call s has landed.
//   * recv (one block): load the own flag with acquire semantics and, when it
//     holds s, copy the slot into the output; the observed value is written
//     out for the wrapper, which raises on any other value. Nothing spins on
//     the flag: kernels of different processes on one card do not run at
//     the same time without MPS, so a spin would wait for a time slice.
//
// Bound: bytes, 2 x C x Hf x 4 (the tail read once, the halo written once):
// 64 KB at C = 128, H = 32 complex samples, 0.02 us at 3.35 TB/s. A launch
// and the host barrier take far longer; latency is what the card shows.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr size_t kFlagBytes = 256;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
halo_put(const float* __restrict__ x, long long xs, int W, int Hf, int C, float* slot,
         unsigned long long* flag, unsigned long long seq) {
  const int n = C * Hf;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / Hf;
    const int j = i - c * Hf;
    slot[i] = x[c * xs + (W - Hf) + j];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(flag), "l"(seq) : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
halo_recv(const float* slot, const unsigned long long* flag, unsigned long long seq, int n,
          float* __restrict__ out, unsigned long long* seen_out) {
  __shared__ unsigned long long seen;
  if (threadIdx.x == 0) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(flag) : "memory");
    seen = v;
    *seen_out = v;
  }
  __syncthreads();
  if (seen != seq) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = __ldcv(slot + i);
}

char* slot_base(void* buf, unsigned long long slot_floats, unsigned long long seq) {
  return static_cast<char*>(buf) + kFlagBytes + (seq & 1ull) * slot_floats * sizeof(float);
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t (0 = success).

int rf_halo_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Allocate and zero this rank's receive buffer; write its IPC handle.
int rf_halo_alloc(int device, unsigned long long slot_floats, void** buf, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = kFlagBytes + 2 * slot_floats * sizeof(float);
  e = cudaMalloc(buf, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(*buf, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *buf);
  return static_cast<int>(e);
}

// Map a neighbour's buffer from its handle.
int rf_halo_open(int device, const void* handle, void** peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(peer, h, cudaIpcMemLazyEnablePeerAccess));
}

int rf_halo_close(int device, void* peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaIpcCloseMemHandle(peer));
}

int rf_halo_free(int device, void* buf) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFree(buf));
}

// x: (C, W) float words with row stride xs; the last Hf words of each row go
// to the neighbour's slot seq & 1, then its flag seq & 1 is set to seq.
int rf_halo_put(int device, const float* x, long long xs, int W, int Hf, int C, void* peer,
                unsigned long long slot_floats, unsigned long long seq, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* slot = reinterpret_cast<float*>(slot_base(peer, slot_floats, seq));
  unsigned long long* flag = static_cast<unsigned long long*>(peer) + (seq & 1ull);
  halo_put<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, xs, W, Hf, C, slot, flag,
                                                                   seq);
  return static_cast<int>(cudaGetLastError());
}

// Copy this rank's slot seq & 1 (n words) into out when its flag holds seq;
// the flag's value goes to seen.
int rf_halo_recv(int device, void* buf, unsigned long long slot_floats, int n, float* out,
                 unsigned long long seq, unsigned long long* seen, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* slot = reinterpret_cast<const float*>(slot_base(buf, slot_floats, seq));
  const unsigned long long* flag = static_cast<const unsigned long long*>(buf) + (seq & 1ull);
  halo_recv<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(slot, flag, seq, n, out,
                                                                    seen);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
