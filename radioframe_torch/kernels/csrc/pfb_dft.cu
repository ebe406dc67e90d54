// K-tap type-1 polyphase accumulation over M-sample frames + M-point DFT,
// for Hopper: the channelizer's PFB front half.
//
// Replaces the Pallas TPU kernel radioframe/kernels/pfb_dft.py::_kernel
// (driven by FusedPfbDft.call_planes). Same function, rethought for a GPU:
//
//   * The TPU kernel carries K-1 frames of history in VMEM scratch across a
//     sequential grid. GPU blocks run in no order, so here each block owns
//     one frame and re-reads its own K-1 preceding frames from global memory
//     (or from the carried tail for negative frame indices). Neighbouring
//     blocks read the same frames, so the K-fold re-read is served mostly
//     by L2.
//   * The DFT is an in-place radix-2 FFT of the frame in shared memory
//     (M complex float32 = 32 KB at M = 4096) with a float32 twiddle table
//     built in float64 on the host, not the TPU's Cooley-Tukey matrix
//     products on the MXU (and so no bf16x3 split: FP32 throughout).
//   * Output is (F, M) re/im planes in channel order, written coalesced.
//   * Bound: device-memory bytes. Each input sample is read once (8 B) and
//     each output written once (8 B): 134 MB at M = 4096, F = 2048, ~40 us
//     at 3.35 TB/s, against ~0.6 GFLOP of FFT and polyphase arithmetic.
//     This first form is limited instead by the FFT's shared-memory passes
//     (log2 M stages, a barrier each) and the L2 re-reads; the design keeps
//     device-memory traffic at the bound and leaves those to a later PR.

#include "channelizer.cuh"

namespace {

__global__ void __launch_bounds__(512)
pfb_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
               const float2* __restrict__ tail, const float* __restrict__ h,
               const float2* __restrict__ tw, float* __restrict__ yr, float* __restrict__ yi,
               int M, int log2m, int K) {
  extern __shared__ float2 buf[];
  const long long f = blockIdx.x;
  rf::pfb_fft_frame(xr, xi, xs, tail, h, tw, M, log2m, K, f, buf);
  for (int c = threadIdx.x; c < M; c += blockDim.x) {
    const float2 y = buf[c];
    yr[f * M + c] = y.x;
    yi[f * M + c] = y.y;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rf_pfb_dft(const float* xr, const float* xi, long long xs, const void* tail, const float* h,
               const void* tw, float* yr, float* yi, int M, int log2m, int K, int F,
               int threads, void* stream) {
  const size_t smem = sizeof(float2) * static_cast<size_t>(M);
  cudaError_t err = cudaFuncSetAttribute(pfb_dft_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pfb_dft_kernel<<<F, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, xs, static_cast<const float2*>(tail), h, static_cast<const float2*>(tw), yr, yi,
      M, log2m, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
