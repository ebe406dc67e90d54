// Fused NCO mix + stage-1 polyphase FIR (decimate by R1) + stage-2
// polyphase FIR (decimate by R2) + per-channel input power, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/fused_frontend2.py::_kernel
// (driven by FusedFrontend2.step_planes). Same function, rethought for a GPU:
//
//   * One thread block owns one channel and one tile of Q2 final-rate
//     outputs; tiles run in parallel, in no order. Nothing is carried from
//     one block to the next (the TPU kernel carried mixed history in VMEM
//     scratch across a sequential grid, and built the stage-2 history on the
//     host). Instead each block reads its own raw input halo of
//     Hc = H2*R1 + H1 samples from global memory, or from the carried raw
//     tail for negative sample indices, and re-mixes every sample at its
//     absolute DDS index theta(n) = (acc + word*n) mod 2^32.
//   * Stage-1 outputs stay in shared memory; stage 2 folds them there. The
//     only global write is at the final rate (R1*R2 below the input).
//   * Bound: device-memory bytes. Each f32 IQ sample is read once (8 B), plus
//     Hc/(Q2*R1*R2) re-read at tile edges (about 10% at the flagship's
//     Q2=256, R1*R2=32, Hc=800), against about 20 multiply-adds per input
//     sample (about 10 for stage 1, 4 for the mix, 6 for stage 2) and one
//     sincosf. The tiling answers that bound: tiles are long enough that the
//     halo re-read stays near 10%, the mixed window and the stage-1 outputs
//     are kept in shared memory in a polyphase (phase-major) layout so both
//     FIR stages read it with unit stride across threads, and consecutive
//     threads load consecutive input samples.
//   * Per-tile power partials go to a (C, n_tiles) buffer that the caller
//     sums: deterministic, unlike atomics.
//
// The DDS phase is formed in uint32 (signed overflow is undefined in C++),
// reinterpreted as int32, converted to float, then scaled by
// -(2 pi) 2^-32 — the reference's order, so the angles agree bit for bit.
// Single-stage mode is R2 = 1, J2 = 0 with a stage-2 tap of 1.0 (exact).
// int16 input is ADC counts; the 2^-15 scale is folded into the stage-1 taps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
fused_frontend2_kernel(const Tin* __restrict__ xr, const Tin* __restrict__ xi,
                       long long ch_stride, long long t_stride,
                       const float2* __restrict__ tail, const int* __restrict__ words,
                       const int* __restrict__ acc, const float* __restrict__ w1,
                       const float* __restrict__ w2, float2* __restrict__ y,
                       float* __restrict__ pow_part, int T, int R1, int J0, int R2,
                       int J2, int Hc, int Q2, int M2, float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int D = R1 * R2;
  const int NF2 = Q2 + J2;        // stage-1 frames of R2 outputs
  const int N1 = NF2 * R2;        // stage-1 outputs this tile needs
  const int NF = N1 + J0;         // raw frames of R1 samples
  const int NS = NF * R1;         // raw window = Q2*D + Hc
  const int K1 = (J0 + 1) * R1;
  const int K2 = (J2 + 1) * R2;

  float* sxr = smem;              // [R1][NF] mixed window, phase-major
  float* sxi = sxr + NS;
  float* s1r = sxi + NS;          // [R2][NF2] stage-1 outputs, phase-major
  float* s1i = s1r + N1;
  float* sw1 = s1i + N1;
  float* sw2 = sw1 + K1;
  float* red = sw2 + K2;          // [kThreads / 32]

  for (int k = threadIdx.x; k < K1; k += blockDim.x) sw1[k] = w1[k];
  for (int k = threadIdx.x; k < K2; k += blockDim.x) sw2[k] = w2[k];

  const uint32_t word = static_cast<uint32_t>(words[c]);
  const uint32_t a0 = static_cast<uint32_t>(acc[c]);
  const Tin* xrc = xr + c * ch_stride;
  const Tin* xic = xi + c * ch_stride;
  const float2* tc = tail + static_cast<long long>(c) * Hc;
  const long long n0 = static_cast<long long>(tile) * Q2 * D - Hc;  // sample index of window[0]

  float pw = 0.f;
  for (int t = threadIdx.x; t < NS; t += blockDim.x) {
    const long long n = n0 + t;
    float re = 0.f, im = 0.f;
    if (n < 0) {
      const float2 v = tc[n + Hc];
      re = v.x;
      im = v.y;
    } else if (n < T) {
      re = static_cast<float>(xrc[n * t_stride]);
      im = static_cast<float>(xic[n * t_stride]);
      if (t >= Hc) pw += re * re + im * im;  // body samples only: each counted once
    }
    const uint32_t theta = a0 + word * static_cast<uint32_t>(n);
    const float ang = static_cast<float>(static_cast<int32_t>(theta)) * scale;
    float s, co;
    sincosf(ang, &s, &co);
    const int f = t / R1;
    const int p = t - f * R1;
    sxr[p * NF + f] = re * co - im * s;
    sxi[p * NF + f] = re * s + im * co;
  }

  for (int off = 16; off > 0; off >>= 1) pw += __shfl_down_sync(0xffffffffu, pw, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = pw;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) s += red[w];
    pow_part[static_cast<long long>(c) * n_tiles + tile] = s;
  }

  // stage 1: y1[i] = sum_{j,p} w1[j*R1 + p] * mixed[(i + j)*R1 + p]
  for (int i = threadIdx.x; i < N1; i += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j <= J0; ++j) {
      for (int p = 0; p < R1; ++p) {
        const float w = sw1[j * R1 + p];
        ar = fmaf(w, sxr[p * NF + i + j], ar);
        ai = fmaf(w, sxi[p * NF + i + j], ai);
      }
    }
    const int f2 = i / R2;
    const int p2 = i - f2 * R2;
    s1r[p2 * NF2 + f2] = ar;
    s1i[p2 * NF2 + f2] = ai;
  }
  __syncthreads();

  // stage 2: y[q] = sum_{j,p} w2[j*R2 + p] * y1[(q + j)*R2 + p]
  for (int q = threadIdx.x; q < Q2; q += blockDim.x) {
    const long long qg = static_cast<long long>(tile) * Q2 + q;
    if (qg >= M2) break;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j <= J2; ++j) {
      for (int p = 0; p < R2; ++p) {
        const float w = sw2[j * R2 + p];
        ar = fmaf(w, s1r[p * NF2 + q + j], ar);
        ai = fmaf(w, s1i[p * NF2 + q + j], ai);
      }
    }
    y[static_cast<long long>(c) * M2 + qg] = make_float2(ar, ai);
  }
}

template <typename Tin>
int launch(const Tin* xr, const Tin* xi, long long ch_stride, long long t_stride,
           const void* tail, const int* words, const int* acc, const float* w1,
           const float* w2, void* y, float* pow_part, int C, int T, int R1, int J0,
           int R2, int J2, int Hc, int Q2, float scale, void* stream) {
  const int D = R1 * R2;
  const int M2 = T / D;
  const int n_tiles = (M2 + Q2 - 1) / Q2;
  const int N1 = (Q2 + J2) * R2;
  const int NS = (N1 + J0) * R1;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(NS) + 2 * N1 + (J0 + 1) * R1 + (J2 + 1) * R2 + kThreads / 32);
  cudaError_t err = cudaFuncSetAttribute(fused_frontend2_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_tiles, C);
  fused_frontend2_kernel<Tin><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, ch_stride, t_stride, static_cast<const float2*>(tail), words, acc, w1, w2,
      static_cast<float2*>(y), pow_part, T, R1, J0, R2, J2, Hc, Q2, M2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rf_fused_frontend2_f32(const float* xr, const float* xi, long long ch_stride,
                           long long t_stride, const void* tail, const int* words,
                           const int* acc, const float* w1, const float* w2, void* y,
                           float* pow_part, int C, int T, int R1, int J0, int R2, int J2,
                           int Hc, int Q2, float scale, void* stream) {
  return launch<float>(xr, xi, ch_stride, t_stride, tail, words, acc, w1, w2, y, pow_part,
                       C, T, R1, J0, R2, J2, Hc, Q2, scale, stream);
}

int rf_fused_frontend2_i16(const int16_t* xr, const int16_t* xi, long long ch_stride,
                           long long t_stride, const void* tail, const int* words,
                           const int* acc, const float* w1, const float* w2, void* y,
                           float* pow_part, int C, int T, int R1, int J0, int R2, int J2,
                           int Hc, int Q2, float scale, void* stream) {
  return launch<int16_t>(xr, xi, ch_stride, t_stride, tail, words, acc, w1, w2, y,
                         pow_part, C, T, R1, J0, R2, J2, Hc, Q2, scale, stream);
}

}  // extern "C"
