// K-tap type-1 polyphase accumulation over M-sample frames + M-point DFT,
// for Hopper: the channelizer's PFB front half (K3), and K3's stage
// variants (K9) as the kernel's template argument.
//
// Replaces the Pallas TPU kernel radioframe/kernels/pfb_dft.py::_kernel
// (driven by FusedPfbDft.call_planes). Same function, rethought for a GPU:
//
//   * The TPU kernel carries K-1 frames of history in VMEM scratch across a
//     sequential grid. GPU blocks run in no order, so each frame's threads
//     re-read its K-1 preceding frames from global memory (or from the
//     carried tail for negative frame indices); neighbouring blocks read the
//     same frames, so the K-fold re-read is served by L2. Registers cannot
//     carry that history instead: a thread's 16 points over K-1 = 7 frames
//     would take 224 registers, and shared memory cannot hold K frames of
//     4096 points (256 KB).
//   * The DFT is rf::fft (channelizer.cuh), the register-resident
//     mixed-radix Stockham FFT, FP32 with a float64-built twiddle table
//     staged in shared memory, not the TPU's Cooley-Tukey matrix products on
//     the MXU (and so no bf16x3 split). Each of the M/16 threads of a frame
//     computes its 16 polyphase points straight into the registers the FFT
//     starts from, and stores its 16 outputs from the registers the FFT
//     ends in: the frame crosses shared memory twice at M = 4096.
//   * Blocks are persistent: a grid that fills the SMs walks the frames, so
//     the twiddle table is staged once per block, not once per frame.
//   * Output is (F, M) re/im planes in channel order, written coalesced.
//   * Bound: device-memory bytes. Each input sample is read once (8 B) and
//     each output written once (8 B): 134 MB at M = 4096, F = 2048, ~40 us
//     at 3.35 TB/s, against ~0.6 GFLOP of FFT and polyphase arithmetic.
//     Measured by chip_smoke.py on an H100 SXM (700 W): 0.166 ms, 24% of
//     that bound (0.276 ms with the radix-2 FFT before). What is left above
//     it is the polyphase's K-fold re-read of input and taps through L2
//     (pfb_only alone 0.12 ms); the FFT alone (dft_only) takes 0.058 ms.
//
// K9 replaces the Pallas TPU kernel tools/probe_pfbdft_stages.py::_kern, the
// cost decomposition of K3. Its variants, each with a plain version in
// kernels/pfb_dft.py:
//   base_b3     K3 itself (the same code path, so the same bits);
//   pfb_only    the polyphase accumulation alone, sample order;
//   pfb_noshift the probe's timing-only arithmetic: every tap reads the
//               current frame (no shifted history), sample order;
//   dft_only    the DFT of the raw frame (rf::fft), no polyphase;
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

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y)));
}

__host__ __device__ constexpr bool uses_fft(int v) { return v == kBase || v == kDftOnly; }

// ct: the batched form's tables, complex: W1 (M1 x M1, [n1][k1]), then TW
// (M2 x M1, [n2][k1] = e^{-2 pi i n2 k1 / M}), then W2 (M2 x M2, [n2][k2]).
// The FFT variants run persistent blocks of G = blockDim / (M/16) frames at a
// time (frame group g = threadIdx / (M/16)); the others one block per frame.
template <int V>
__global__ void __launch_bounds__(512)
pfb_dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
               const float2* __restrict__ tail, const float* __restrict__ h,
               const float2* __restrict__ tw, const float2* __restrict__ ct,
               float* __restrict__ yr, float* __restrict__ yi, int M, int K, int F, int M1,
               int M2) {
  extern __shared__ float2 buf[];
  if constexpr (uses_fft(V)) {
    const int T = rf::fft_threads(M);
    const int G = blockDim.x / T;
    const int g = threadIdx.x / T;
    const int t = threadIdx.x - g * T;
    float2* tws = buf;
    float2* ex = buf + rf::fft_twiddle_points(M) + g * rf::fft_exchange_points(M);
    rf::stage_twiddles(tws, tw, M);
    for (long long f0 = static_cast<long long>(blockIdx.x) * G; f0 < F;
         f0 += static_cast<long long>(gridDim.x) * G) {
      const long long f = f0 + g;
      const bool live = f < F;
      float2 v[rf::kFftP];
      if (!live) {
#pragma unroll
        for (int m = 0; m < rf::kFftP; ++m) v[m] = make_float2(0.f, 0.f);
      } else if constexpr (V == kBase) {
        rf::pfb_frame(v, xr, xi, xs, tail, h, M, K, f, t);
      } else {
#pragma unroll
        for (int m = 0; m < rf::kFftP; ++m) {
          const long long n = (f * M + t + T * m) * xs;
          v[m] = m < M ? make_float2(xr[n], xi[n]) : make_float2(0.f, 0.f);
        }
      }
      rf::fft(v, ex, tws, M, t);
      if (live) {
#pragma unroll
        for (int m = 0; m < rf::kFftP; ++m) {
          if (m < M) {
            yr[f * M + t + T * m] = v[m].x;
            yi[f * M + t + T * m] = v[m].y;
          }
        }
      }
    }
    return;
  }
  const long long f = blockIdx.x;
  if constexpr (V == kPfbOnly || V == kPfbNoshift) {
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
      const float2 u = rf::polyphase(xr, xi, xs, tail, h, M, K, f, p, V == kPfbNoshift);
      yr[f * M + p] = u.x;
      yi[f * M + p] = u.y;
    }
  } else if constexpr (V == kBatched) {
    float2* u = buf;      // the polyphase frame, then the output in channel order
    float2* b = buf + M;  // stage one's output after the twiddle, [k1][n2]
    const float2* w1 = ct;
    const float2* twc = ct + M1 * M1;
    const float2* w2 = twc + M2 * M1;
    for (int p = threadIdx.x; p < M; p += blockDim.x)
      u[p] = rf::polyphase(xr, xi, xs, tail, h, M, K, f, p, false);
    __syncthreads();
    // A[k1][n2] = sum_n1 W1[n1][k1] u[n1 M2 + n2]; B = A * TW[n2][k1]
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const int k1 = i / M2;
      const int n2 = i - k1 * M2;
      float2 acc = make_float2(0.f, 0.f);
      for (int n1 = 0; n1 < M1; ++n1) acc = cfma(w1[n1 * M1 + k1], u[n1 * M2 + n2], acc);
      b[i] = rf::cmul(acc, twc[n2 * M1 + k1]);
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
    for (int c = threadIdx.x; c < M; c += blockDim.x) {
      yr[f * M + c] = u[c].x;
      yi[f * M + c] = u[c].y;
    }
  }
}

template <int V>
cudaError_t launch(const float* xr, const float* xi, long long xs, const void* tail,
                   const float* h, const void* tw, const void* ct, float* yr, float* yi, int M,
                   int K, int M1, int M2, int F, cudaStream_t stream) {
  int threads, grid;
  size_t smem;
  cudaError_t err;
  if constexpr (uses_fft(V)) {  // persistent: as many blocks as stay resident
    threads = rf::fft_threads(M) < 32 ? 32 : rf::fft_threads(M);
    const int G = threads / rf::fft_threads(M);
    smem = sizeof(float2) *
           (rf::fft_twiddle_points(M) + static_cast<size_t>(G) * rf::fft_exchange_points(M));
    int resident = 0;
    err = rf::resident_blocks<pfb_dft_kernel<V>>(threads, smem, &resident);
    if (err != cudaSuccess) return err;
    grid = (F + G - 1) / G < resident ? (F + G - 1) / G : resident;
  } else {
    threads = M / 2 < 32 ? 32 : (M / 2 > 512 ? 512 : M / 2);
    smem = V == kBatched ? 2 * sizeof(float2) * static_cast<size_t>(M) : 0;
    grid = F;
    err = cudaFuncSetAttribute(pfb_dft_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pfb_dft_kernel<V><<<grid, threads, smem, stream>>>(
      xr, xi, xs, static_cast<const float2*>(tail), h, static_cast<const float2*>(tw),
      static_cast<const float2*>(ct), yr, yi, M, K, F, M1, M2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). variant: the
// index in VARIANTS of kernels/pfb_dft.py (0 = K3); tw is the FFT's twiddle
// table (kernels/fft_plan.py), read by base_b3 and dft_only; ct, M1, M2 are
// read by the batched variant only.
int rf_pfb_dft(const float* xr, const float* xi, long long xs, const void* tail, const float* h,
               const void* tw, const void* ct, float* yr, float* yi, int M, int K, int M1,
               int M2, int F, int variant, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kBase:
      err = launch<kBase>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, K, M1, M2, F, s);
      break;
    case kPfbOnly:
      err = launch<kPfbOnly>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, K, M1, M2, F, s);
      break;
    case kPfbNoshift:
      err = launch<kPfbNoshift>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, K, M1, M2, F, s);
      break;
    case kDftOnly:
      err = launch<kDftOnly>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, K, M1, M2, F, s);
      break;
    case kBatched:
      err = launch<kBatched>(xr, xi, xs, tail, h, tw, ct, yr, yi, M, K, M1, M2, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
