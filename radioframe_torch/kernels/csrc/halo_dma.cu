// K7: ring halo exchange through device memory, for Hopper, ordered on the
// card.
//
// Replaces the Pallas TPU kernel radioframe/kernels/halo_dma.py::_halo_kernel
// (driven by ring_halo_dma / causal_halo_dma): every shard of the time axis
// sends the last H samples of each channel to its right neighbour, which
// thereby receives its causal halo. The TPU kernel starts a remote DMA and
// orders it with send/recv semaphores that the DMA engine waits on. Here the
// ranks are processes, each owning one buffer made with cudaMalloc (a
// dedicated allocation, so that its IPC handle's offset is 0); each rank maps
// its right neighbour's buffer (to put) and its left neighbour's (to
// acknowledge) with cudaIpcOpenMemHandle, on the same card or a peer card.
//
// Buffer: a 256-byte header of u64 words (the two sequence flags, written by
// the left neighbour's put; the ack word, written by the right neighbour's
// recv, on its own 64-byte line), then two payload slots of C x Hf float
// words (complex samples travel as float pairs, the reference's contract).
// The wrapper (kernels/halo_dma.py) owns the layout and the parity schedule
// and passes addresses; call s uses slot and flag s & 1.
//
//   * put, on the sender's stream: the stream waits until the sender's own
//     ack word is >= s - 1 (cuStreamWaitValue64, GEQ): the right neighbour
//     has consumed call s - 1, and so call s - 2, the last user of slot
//     s & 1. Then one block copies the local tail words into that slot,
//     fences at system scope and release-stores s into the flag s & 1.
//   * recv, on the receiver's stream: the stream waits until its own flag
//     s & 1 is >= s. One block acquire-loads the flag; a value other than s
//     (which the schedule rules out) is counted into an error record,
//     never silently. It copies the slot into the output, then
//     release-stores s into the left neighbour's ack word.
//
// Nothing waits on the host and no kernel spins: a stream waiting on a value
// in device memory holds no SM, which matters because kernels of different
// processes on one card without MPS only time-slice. The wait and write
// entry points come from cudaGetDriverEntryPoint, so no -lcuda is needed.
//
// Bound: bytes, 2 x C x Hf x 4 (the tail read once, the halo written once):
// 64 KB at C = 128, H = 32 complex samples, 0.02 us at 3.35 TB/s. Two
// launches and the cross-process wake-ups take far longer; latency is what
// the card shows: with four ranks time-slicing one H100 SXM (700 W),
// 0.019 to 0.63 ms per exchange on different machines, against 1.5 to 2.3
// ms for the ppermute transport through gloo and 1.8 ms for the
// host-ordered first form (chip_smoke.py). The spread is how soon the card
// switches from a context whose stream waits to the one that writes.

#include <cstdint>
#include <cstring>
#include <cuda.h>  // driver types only; the functions come through entry points
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

typedef CUresult (*WaitValue64Fn)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);
typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*DeviceGetAttributeFn)(int*, CUdevice_attribute, CUdevice);

// A driver function by name, at the CUDA 12.0 ABI, without linking libcuda.
template <class F>
cudaError_t driver_fn(const char* name, F* fn) {
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, reinterpret_cast<void**>(fn), 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, reinterpret_cast<void**>(fn), cudaEnableDefault,
                                          &found);
#endif
  if (e == cudaSuccess && found != cudaDriverEntryPointSuccess) e = cudaErrorSymbolNotFound;
  return e;
}

// Enqueue "wait until *addr >= value" on the stream; a CUresult.
int wait_geq(void* stream, const void* addr, unsigned long long value) {
  static WaitValue64Fn wait = nullptr;
  if (wait == nullptr) {
    const cudaError_t e = driver_fn("cuStreamWaitValue64", &wait);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(wait(static_cast<CUstream>(stream),
                               reinterpret_cast<CUdeviceptr>(addr), value,
                               CU_STREAM_WAIT_VALUE_GEQ));
}

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

// errors: [wrong flags seen, the first such call's number, the value it saw]
__global__ void __launch_bounds__(kThreads)
halo_recv(const float* slot, const unsigned long long* flag, unsigned long long seq, int n,
          float* __restrict__ out, unsigned long long* ack, unsigned long long ack_value,
          unsigned long long* errors) {
  __shared__ unsigned long long seen;
  if (threadIdx.x == 0) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(flag) : "memory");
    seen = v;
    if (v != seq) {
      atomicAdd(errors, 1ull);
      if (atomicCAS(errors + 1, 0ull, seq) == 0ull) errors[2] = v;
    }
  }
  __syncthreads();
  if (seen == seq)
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = __ldcv(slot + i);
  __syncthreads();  // every read of the slot is done before it is handed back
  if (threadIdx.x == 0) {
    __threadfence_system();
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(ack), "l"(ack_value) : "memory");
  }
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t or a CUresult (0 = success).

int rf_halo_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Whether the card supports 64-bit stream memory operations (the waits),
// as CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS.
int rf_halo_stream_mem_ops(int device, int* supported) {
  DeviceGetFn get = nullptr;
  DeviceGetAttributeFn attr = nullptr;
  cudaError_t e = driver_fn("cuDeviceGet", &get);
  if (e == cudaSuccess) e = driver_fn("cuDeviceGetAttribute", &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUdevice dev;
  CUresult r = get(&dev, device);
  if (r == CUDA_SUCCESS) r = attr(supported, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev);
  return static_cast<int>(r);
}

// Allocate and zero this rank's buffer of `bytes`; write its IPC handle.
int rf_halo_alloc(int device, unsigned long long bytes, void** buf, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// On the stream: wait until *own_ack >= ack_wait, then copy the last Hf of
// each row's W words of x (C rows, stride xs) into slot and release-store seq
// into flag (both in the right neighbour's buffer).
int rf_halo_put(int device, const float* x, long long xs, int W, int Hf, int C, void* slot,
                void* flag, const void* own_ack, unsigned long long ack_wait,
                unsigned long long seq, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int r = wait_geq(stream, own_ack, ack_wait);
  if (r != 0) return r;
  halo_put<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, xs, W, Hf, C, static_cast<float*>(slot), static_cast<unsigned long long*>(flag), seq);
  return static_cast<int>(cudaGetLastError());
}

// On the stream: wait until *flag >= seq (this rank's buffer), copy n words
// of slot into out, then release-store ack_value into peer_ack (the left
// neighbour's ack word); a flag other than seq goes to errors.
int rf_halo_recv(int device, const void* slot, const void* flag, unsigned long long seq, int n,
                 float* out, void* peer_ack, unsigned long long ack_value, void* errors,
                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int r = wait_geq(stream, flag, seq);
  if (r != 0) return r;
  halo_recv<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slot), static_cast<const unsigned long long*>(flag), seq, n, out,
      static_cast<unsigned long long*>(peer_ack), ack_value,
      static_cast<unsigned long long*>(errors));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
