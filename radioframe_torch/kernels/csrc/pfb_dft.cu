// K-tap type-1 polyphase accumulation over M-sample frames + M-point DFT,
// for Hopper: the channelizer's PFB front half (K3), and K3's stage
// variants (K9) as the kernel's template argument.
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
//
// K9 replaces the Pallas TPU kernel tools/probe_pfbdft_stages.py::_kern, the
// cost decomposition of K3. Its variants, each with a plain version in
// kernels/pfb_dft.py:
//   base_b3     K3 itself (the same code path, so the same bits);
//   pfb_only    the polyphase accumulation alone, sample order;
//   pfb_noshift the probe's timing-only arithmetic: every tap reads the
//               current frame (no shifted history), sample order;
//   dft_only    the DFT of the raw frame, no polyphase;
//   batched_b3  the polyphase, then the DFT as the probe's explicit
//               Cooley-Tukey product: M1-point dense products, the twiddle,
//               M2-point dense products (M = M1 M2), FP32 on the CUDA cores,
//               from float64-built tables. The first CT form of the port and
//               the baseline of a tensor-core one; its M1 M2 (M1 + M2)
//               complex products per frame are ~5x the FFT's work, so it is
//               bound by operations, not bytes.

#include "channelizer.cuh"

namespace {

enum Variant : int { kBase = 0, kPfbOnly = 1, kPfbNoshift = 2, kDftOnly = 3, kBatched = 4 };

// u[p] of frame f: sum_t h[t*M + p] * frame(f - t)[p] (frame(f) for every tap
// when noshift), in K3's order of operations.
__device__ __forceinline__ float2 polyphase(const float* __restrict__ xr,
                                            const float* __restrict__ xi, long long xs,
                                            const float2* __restrict__ tail,
                                            const float* __restrict__ h, int M, int K,
                                            long long f, int p, bool noshift) {
  float ar = 0.f, ai = 0.f;
  for (int t = 0; t < K; ++t) {
    const long long g = noshift ? f : f - t;
    float vr, vi;
    if (g >= 0) {
      const long long n = (g * M + p) * xs;
      vr = xr[n];
      vi = xi[n];
    } else {
      const float2 v = tail[(K - 1 + g) * M + p];
      vr = v.x;
      vi = v.y;
    }
    const float w = h[t * M + p];
    ar = fmaf(w, vr, ar);
    ai = fmaf(w, vi, ai);
  }
  return make_float2(ar, ai);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y)));
}

// ct: the batched form's tables, complex: W1 (M1 x M1, [n1][k1]), then TW
// (M2 x M1, [n2][k1] = e^{-2 pi i n2 k1 / M}), then W2 (M2 x M2, [n2][k2]).
template <int V>
__global__ void __launch_bounds__(512)
pfb_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
               const float2* __restrict__ tail, const float* __restrict__ h,
               const float2* __restrict__ tw, const float2* __restrict__ ct,
               float* __restrict__ yr, float* __restrict__ yi, int M, int log2m, int K, int M1,
               int M2) {
  extern __shared__ float2 buf[];
  const long long f = blockIdx.x;
  if constexpr (V == kBase) {
    rf::pfb_fft_frame(xr, xi, xs, tail, h, tw, M, log2m, K, f, buf);
  } else if constexpr (V == kPfbOnly || V == kPfbNoshift) {
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
      const float2 u = polyphase(xr, xi, xs, tail, h, M, K, f, p, V == kPfbNoshift);
      yr[f * M + p] = u.x;
      yi[f * M + p] = u.y;
    }
    return;
  } else if constexpr (V == kDftOnly) {
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
      const long long n = (f * M + p) * xs;
      buf[__brev(p) >> (32 - log2m)] = make_float2(xr[n], xi[n]);
    }
    __syncthreads();
    rf::fft_inplace(buf, tw, M);
  } else {
    float2* u = buf;      // the polyphase frame, then the output in channel order
    float2* b = buf + M;  // stage one's output after the twiddle, [k1][n2]
    const float2* w1 = ct;
    const float2* twc = ct + M1 * M1;
    const float2* w2 = twc + M2 * M1;
    for (int p = threadIdx.x; p < M; p += blockDim.x)
      u[p] = polyphase(xr, xi, xs, tail, h, M, K, f, p, false);
    __syncthreads();
    // A[k1][n2] = sum_n1 W1[n1][k1] u[n1 M2 + n2]; B = A * TW[n2][k1]
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const int k1 = i / M2;
      const int n2 = i - k1 * M2;
      float2 acc = make_float2(0.f, 0.f);
      for (int n1 = 0; n1 < M1; ++n1) acc = cfma(w1[n1 * M1 + k1], u[n1 * M2 + n2], acc);
      b[i] = cmul(acc, twc[n2 * M1 + k1]);
    }
    __syncthreads();
    // X[M1 k2 + k1] = sum_n2 B[k1][n2] W2[n2][k2]
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const int k1 = i / M2;
      const int k2 = i - k1 * M2;
      float2 acc = make_float2(0.f, 0.f);
      for (int n2 = 0; n2 < M2; ++n2) acc = cfma(b[k1 * M2 + n2], w2[n2 * M2 + k2], acc);
      u[M1 * k2 + k1] = acc;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < M; c += blockDim.x) {
    const float2 y = buf[c];
    yr[f * M + c] = y.x;
    yi[f * M + c] = y.y;
  }
}

template <int V>
cudaError_t launch(const float* xr, const float* xi, long long xs, const void* tail,
                   const float* h, const void* tw, const void* ct, float* yr, float* yi, int M,
                   int log2m, int K, int M1, int M2, int F, int threads, cudaStream_t stream) {
  const int frames = V == kBatched ? 2 : (V == kPfbOnly || V == kPfbNoshift ? 0 : 1);
  const size_t smem = sizeof(float2) * static_cast<size_t>(M) * frames;
  cudaError_t err = cudaFuncSetAttribute(pfb_dft_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  pfb_dft_kernel<V><<<F, threads, smem, stream>>>(
      xr, xi, xs, static_cast<const float2*>(tail), h, static_cast<const float2*>(tw),
      static_cast<const float2*>(ct), yr, yi, M, log2m, K, M1, M2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). variant: the
// index in VARIANTS of kernels/pfb_dft.py (0 = K3); ct, M1, M2 are read by
// the batched variant only.
int rf_pfb_dft(const float* xr, const float* xi, long long xs, const void* tail, const float* h,
               const void* tw, const void* ct, float* yr, float* yi, int M, int log2m, int K,
               int M1, int M2, int F, int threads, int variant, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kBase:
      err = launch<kBase>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, log2m, K, M1, M2, F, threads, s);
      break;
    case kPfbOnly:
      err = launch<kPfbOnly>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, log2m, K, M1, M2, F,
                             threads, s);
      break;
    case kPfbNoshift:
      err = launch<kPfbNoshift>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, log2m, K, M1, M2, F,
                                threads, s);
      break;
    case kDftOnly:
      err = launch<kDftOnly>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, log2m, K, M1, M2, F,
                             threads, s);
      break;
    case kBatched:
      err = launch<kBatched>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, log2m, K, M1, M2, F,
                             threads, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
