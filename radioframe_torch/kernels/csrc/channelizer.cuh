// Device code shared by the channelizer kernels (pfb_dft.cu, demod_agc.cu,
// channelizer_one.cu) and the flagship back end (ols_demod.cu): the
// shared-memory FFT and the polyphase frame, the per-element demod value, the
// per-channel AGC walk and a one-shot grid barrier. Everything is in channel
// order (channel c at +c*fs/M); planes are frame-major (F, M), so
// neighbouring threads touch neighbouring channels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rf {

enum Mode : int { kSSB = 0, kCW = 1, kAM = 2, kNFM = 3, kLSB = 4 };
constexpr float kDcPole = 0.995f;  // AM DC-block pole (ops/demod.py dc_block)

__device__ __forceinline__ bool enabled(int en, int mode) { return (en >> mode) & 1; }

// In-place radix-2 DIT FFT of M points in shared memory, bit-reversed input,
// natural-order output: buf[k] = sum_n u[n] e^{-2 pi i n k / M}. tw[k] =
// e^{-2 pi i k / M} for k < M/2. The caller synchronizes after loading buf.
__device__ void fft_inplace(float2* buf, const float2* __restrict__ tw, int M) {
  for (int half = 1; half < M; half <<= 1) {
    const int stride = M / (2 * half);
    for (int b = threadIdx.x; b < M / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = 2 * (b - j) + j;
      const int i1 = i0 + half;
      const float2 w = tw[j * stride];
      const float2 u = buf[i0];
      const float2 v = buf[i1];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      buf[i0] = make_float2(u.x + tr, u.y + ti);
      buf[i1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// Polyphase frame f (block-relative; the K-1 frames before 0 come from the
// carried tail) followed by an in-place radix-2 DIT FFT of M = 2^log2m points
// in shared memory. On return buf[c] = X[c] = sum_p u[p] e^{-2 pi i p c / M},
// u[p] = sum_t h[t*M + p] * frame(f - t)[p]. tw[k] = e^{-2 pi i k / M} for
// k < M/2 (built in float64 on the host, stored as float32).
__device__ void pfb_fft_frame(const float* __restrict__ xr, const float* __restrict__ xi,
                              long long xs, const float2* __restrict__ tail,
                              const float* __restrict__ h, const float2* __restrict__ tw,
                              int M, int log2m, int K, long long f, float2* buf) {
  __syncthreads();  // the caller may still be reading buf from the last frame
  for (int p = threadIdx.x; p < M; p += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int t = 0; t < K; ++t) {
      const long long g = f - t;
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
    buf[__brev(p) >> (32 - log2m)] = make_float2(ar, ai);  // bit-reversed load
  }
  __syncthreads();
  fft_inplace(buf, tw, M);
}

// Per-channel constants and the 7-row carry of the demod/AGC back end.
// Carry rows: 0 am x_prev, 1 am y_prev, 2 nfm re, 3 nfm im, 4 release env,
// 5 attack lpf, 6 power sum.
struct DemodArgs {
  const int* mode;
  const int* cw_word;
  const int* cw_acc;
  const float* rel;
  const float* al;
  const float* tgt;
  const float* mg;
  const float* st_in;  // (7, M)
  float* audio;        // (F, M)
  float* wf;           // (F / wf_avg, M); unused when wf_avg = 0
  float* st_out;       // (7, M)
  float* v;            // (F, M) scratch: the demod value before AM and AGC
  float* p;            // (F, M) scratch: |X|^2
  unsigned int* barrier;
  int M, F, en, wf_avg, apply_agc;  // wf_avg = 0: no power sum, no waterfall
  float dev_scale;  // fs_channel / (2 pi deviation)
  float cw_scale;   // 2 pi / 2^32
};

// The demod value of one element that needs no recurrence: 2 Re for
// SSB/LSB, the CW beat (DDS angle cw_acc + cw_word * f), the NFM
// discriminator against the previous frame (pr, pi). AM channels and
// disabled modes give 0 here; the AM DC block runs in agc_walk.
__device__ __forceinline__ float demod_value(const DemodArgs& a, int c, long long f, float xr,
                                             float xi, float pr, float pi) {
  const int mode = a.mode[c];
  if (!enabled(a.en, mode)) return 0.f;
  switch (mode) {
    case kSSB:
    case kLSB:
      return 2.f * xr;
    case kCW: {
      const uint32_t theta = static_cast<uint32_t>(a.cw_acc[c]) +
                             static_cast<uint32_t>(a.cw_word[c]) * static_cast<uint32_t>(f);
      const float ang = static_cast<float>(static_cast<int32_t>(theta)) * a.cw_scale;
      float s, co;
      sincosf(ang, &s, &co);
      return 2.f * (xr * co - xi * s);
    }
    case kNFM: {
      const float dr = xr * pr + xi * pi;
      const float di = xi * pr - xr * pi;
      return atan2f(di, dr) * a.dev_scale;
    }
    default:
      return 0.f;
  }
}

// One channel's recurrences over all F frames, in order: the AM DC block
// (for every channel when AM is enabled, as the carry demands), the AGC
// release max-decay env = max(|a|, rel*env), the attack one-pole
// lpf = al*lpf + (1-al)*env (lpf = env where al = 0), the gain clip with the
// NFM bypass, the power sum and the frame-averaged waterfall power (these two
// off when wf_avg = 0, carry row 6 then passed through). Reads the phase-one
// scratch with __ldcg: it was written by other blocks.
__device__ void agc_walk(const DemodArgs& a, int c) {
  const int M = a.M;
  const float* st = a.st_in;
  float am_x = st[c], am_y = st[M + c];
  float env = st[4 * M + c], lpf = st[5 * M + c], pw = st[6 * M + c];
  const int mode = a.mode[c];
  const bool en_am = enabled(a.en, kAM);
  const bool is_am = en_am && mode == kAM;
  const bool bypass = mode == kNFM;
  const bool aux = a.wf_avg > 0;
  const float rel = a.rel[c], al = a.al[c], tgt = a.tgt[c], mg = a.mg[c];
  const float avg = static_cast<float>(a.wf_avg);
  float wacc = 0.f;  // the current waterfall line's power sum, over nacc frames
  int nacc = 0;
  long long line = 0;
  // frames loaded per batch; 8, 16 and 32 time the same on an H100: with one
  // warp per SM the walk is paced by its dependent instructions, not by loads
  constexpr int U = 8;
  for (int f0 = 0; f0 < a.F; f0 += U) {
    float pv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = static_cast<long long>(f0 + u) * M + c;
      pv[u] = f0 + u < a.F ? __ldcg(a.p + i) : 0.f;
      vv[u] = f0 + u < a.F ? __ldcg(a.v + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + u;
      if (f >= a.F) break;
      float out = vv[u];
      if (en_am) {
        const float e = sqrtf(pv[u]);
        const float y = (e - am_x) + kDcPole * am_y;
        am_x = e;
        am_y = y;
        if (is_am) out = y;
      }
      if (a.apply_agc) {
        env = fmaxf(fabsf(out), rel * env);
        lpf = al == 0.f ? env : al * lpf + (1.f - al) * env;
        const float gain = fminf(mg, tgt / fmaxf(lpf, 1e-9f));
        if (!bypass) out *= gain;
      }
      a.audio[static_cast<long long>(f) * M + c] = out;
      if (aux) {
        pw += pv[u];
        wacc += pv[u];
        if (++nacc == a.wf_avg) {  // a counter, not a per-frame integer div/mod
          a.wf[line * M + c] = wacc / avg;
          ++line;
          nacc = 0;
          wacc = 0.f;
        }
      }
    }
  }
  float* so = a.st_out;
  so[c] = en_am ? am_x : st[c];
  so[M + c] = en_am ? am_y : st[M + c];
  if (!enabled(a.en, kNFM)) {  // else written by phase one from the last frame
    so[2 * M + c] = st[2 * M + c];
    so[3 * M + c] = st[3 * M + c];
  }
  so[4 * M + c] = a.apply_agc ? env : st[4 * M + c];
  so[5 * M + c] = a.apply_agc ? lpf : st[5 * M + c];
  so[6 * M + c] = pw;
}

// Phase two of a two-phase launch: channels over the whole grid, one warp's
// 32 channels per block before the next warp of any block, so the few
// active warps spread over the SMs.
__device__ void agc_walk_all(const DemodArgs& a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (warp * gridDim.x + blockIdx.x) * 32 + lane;
  for (int c = first; c < a.M; c += gridDim.x * blockDim.x) agc_walk(a, c);
}

// One-shot barrier over a cooperative launch (all blocks resident). The
// counter starts at 0; the fences order phase one's global writes before
// phase two's reads on every SM.
__device__ void grid_barrier(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (atomicAdd(count, 0u) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace rf
