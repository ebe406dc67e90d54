// Fused NCO mix + one real-tap polyphase FIR decimating by R, for Hopper,
// with the cost-decomposition variants of the same kernel.
//
// Replaces the Pallas TPU kernel radioframe/kernels/fused_frontend.py::_kernel
// (driven by FusedFrontend.step) and, through the template argument V, the
// probe kernels of tools/probe_fused.py::_mk_kernel. Function:
//
//   y[c, m] = sum_k wp[k] x[c, mR - H + k] e^{-j theta(mR - H + k)},
//   theta(n) = (acc + word n) mod 2^32, n < 0 read from the raw tail (C, H).
//
// Rethought for a GPU:
//   * One thread block owns one channel and one tile of Q outputs. It reads
//     its own raw halo of H = J0 R samples from the preceding input, or from
//     the carried tail at negative indices, and re-mixes every sample at its
//     absolute DDS index. Nothing is carried between blocks (the TPU kernel
//     got a host-built tail per grid step and wrote time-major output that
//     its wrapper transposed; here output is (C, M) directly).
//   * The DDS phase is formed in uint32 (signed overflow is undefined in
//     C++), reinterpreted as int32, converted to float and scaled, then one
//     sincosf per sample. The TPU's coarse x fine factorization saved
//     transcendentals on its vector unit; one sincosf per 8-byte sample is
//     far below the memory bound here.
//   * Bound: device-memory bytes. 8 B read per input sample, 8 B written per
//     output, against (J0+1) 4 flops per output plus the mix (about 10 flops
//     per input sample at R = 8, J0 = 4). The mixed window is kept in shared
//     memory in a phase-major layout so the FIR reads it with unit stride
//     across threads; consecutive threads load consecutive input samples.
//
// Variants (the TPU probe's, each computing what it computed there):
//   kFull     the kernel itself;
//   kNoOsc    oscillator replaced by the constants cos = 0.6, sin = 0.8;
//   kNoTr     the tile's (C, W = Q R) input block read as if it were
//             time-major (Q, R, C), the probe's "no transpose" (wrong values,
//             same bytes); the H-sample halo is read as it is;
//   kOscOnly  y[m] = sum over the R samples from mR - H of the oscillator;
//   kCopyOnly y[m] = sum over the R samples from mR of the input (no mix).
// An output's value depends on nothing but m, so every tiling gives the
// same bits; kNoTr alone is defined per tile (Q = 128 there, the probe's).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Variant : int { kFull = 0, kNoOsc = 1, kNoTr = 2, kOscOnly = 3, kCopyOnly = 4 };

template <int V>
__global__ void __launch_bounds__(kThreads)
fused_frontend_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      long long ch_stride, long long t_stride,
                      const float2* __restrict__ tail, const int* __restrict__ words,
                      const int* __restrict__ acc, const float* __restrict__ w,
                      float2* __restrict__ y, int C, int T, int R, int J0, int Q, int M,
                      float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int H = J0 * R;
  const int NF = Q + J0;   // frames of R samples in the window
  const int NS = NF * R;   // window = Q R + H samples
  const int K = (J0 + 1) * R;
  const long long W = static_cast<long long>(Q) * R;

  float* sxr = smem;       // [R][NF] mixed window, phase-major
  float* sxi = sxr + NS;
  float* sw = sxi + NS;    // [K] padded polyphase taps
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];

  const uint32_t word = static_cast<uint32_t>(words[c]);
  const uint32_t a0 = static_cast<uint32_t>(acc[c]);
  const float2* tc = tail + static_cast<long long>(c) * H;
  const long long n0 = tile * W - H;  // sample index of window[0]

  for (int t = threadIdx.x; t < NS; t += blockDim.x) {
    const long long n = n0 + t;
    float re = 0.f, im = 0.f;
    if (n < 0) {
      const float2 v = tc[n + H];
      re = v.x;
      im = v.y;
    } else if (n < T) {
      long long row = c, col = n;
      if (V == kNoTr && t >= H) {  // flat (t - H) C + c of the (C, W) block
        const long long q = static_cast<long long>(t - H) * C + c;
        row = q / W;
        col = tile * W + (q - row * W);
      }
      re = xr[row * ch_stride + col * t_stride];
      im = xi[row * ch_stride + col * t_stride];
    }
    float s = 0.8f, co = 0.6f;
    if (V != kNoOsc && V != kCopyOnly) {
      const uint32_t theta = a0 + word * static_cast<uint32_t>(n);
      sincosf(static_cast<float>(static_cast<int32_t>(theta)) * scale, &s, &co);
    }
    const int f = t / R;
    const int p = t - f * R;
    if (V == kOscOnly) {
      sxr[p * NF + f] = co;
      sxi[p * NF + f] = s;
    } else if (V == kCopyOnly) {
      sxr[p * NF + f] = re;
      sxi[p * NF + f] = im;
    } else {
      sxr[p * NF + f] = re * co - im * s;
      sxi[p * NF + f] = re * s + im * co;
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const long long m = static_cast<long long>(tile) * Q + q;
    if (m >= M) break;
    float ar = 0.f, ai = 0.f;
    if (V == kOscOnly || V == kCopyOnly) {
      const int f = V == kOscOnly ? q : q + J0;  // window frame m - J0, or frame m
      for (int p = 0; p < R; ++p) {
        ar += sxr[p * NF + f];
        ai += sxi[p * NF + f];
      }
    } else {
      for (int j = 0; j <= J0; ++j) {
        for (int p = 0; p < R; ++p) {
          const float wk = sw[j * R + p];
          ar = fmaf(wk, sxr[p * NF + q + j], ar);
          ai = fmaf(wk, sxi[p * NF + q + j], ai);
        }
      }
    }
    y[static_cast<long long>(c) * M + m] = make_float2(ar, ai);
  }
}

template <int V>
int launch(const float* xr, const float* xi, long long ch_stride, long long t_stride,
           const void* tail, const int* words, const int* acc, const float* w, void* y, int C,
           int T, int R, int J0, int Q, float scale, void* stream) {
  const int M = T / R;
  const int n_tiles = (M + Q - 1) / Q;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(Q + J0) * R + static_cast<size_t>(J0 + 1) * R);
  cudaError_t err = cudaFuncSetAttribute(fused_frontend_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_tiles, C);
  fused_frontend_kernel<V><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, ch_stride, t_stride, static_cast<const float2*>(tail), words, acc, w,
      static_cast<float2*>(y), C, T, R, J0, Q, M, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown variant.
int rf_fused_frontend(const float* xr, const float* xi, long long ch_stride, long long t_stride,
                      const void* tail, const int* words, const int* acc, const float* w,
                      void* y, int C, int T, int R, int J0, int Q, int variant, float scale,
                      void* stream) {
  switch (variant) {
    case kFull:
      return launch<kFull>(xr, xi, ch_stride, t_stride, tail, words, acc, w, y, C, T, R, J0,
                           Q, scale, stream);
    case kNoOsc:
      return launch<kNoOsc>(xr, xi, ch_stride, t_stride, tail, words, acc, w, y, C, T, R, J0,
                            Q, scale, stream);
    case kNoTr:
      return launch<kNoTr>(xr, xi, ch_stride, t_stride, tail, words, acc, w, y, C, T, R, J0,
                           Q, scale, stream);
    case kOscOnly:
      return launch<kOscOnly>(xr, xi, ch_stride, t_stride, tail, words, acc, w, y, C, T, R,
                              J0, Q, scale, stream);
    case kCopyOnly:
      return launch<kCopyOnly>(xr, xi, ch_stride, t_stride, tail, words, acc, w, y, C, T, R,
                               J0, Q, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
