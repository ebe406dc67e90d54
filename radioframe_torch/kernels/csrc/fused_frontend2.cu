// Fused NCO mix + stage-1 polyphase FIR (decimate by R1) + stage-2
// polyphase FIR (decimate by R2) + per-channel input power, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/fused_frontend2.py::_kernel
// (driven by FusedFrontend2.step_planes). Same function, rethought for a GPU:
//
//   * Persistent strips, an asynchronous load path and per-strip power
//     partials: frontend.cuh, shared with K2. A block walks a strip of chunks
//     of q2 final-rate outputs (q2*R1*R2 raw samples); the grid is about the
//     card's resident blocks (kernels/frontend_plan.py plans strips, chunks
//     and stages; at the flagship's C = 128, T = 131072: 16 KB chunks, three
//     in flight, three blocks an SM). The TPU kernel carried its mixed
//     history in VMEM across a sequential grid; here the block carries in
//     shared memory the last J0 mixed frames (stage 1's history) and the last
//     J2 stage-1 frames (stage 2's). A strip's prologue reads the
//     Hc = J2*R1*R2 + J0*R1 raw samples before it, mixes them and runs stage
//     1 over them.
//   * Decimation at compile time for the pairs the chains build, (R1, R2) =
//     (8, 4), (8, 1) and (2, 2): no integer division in the index maps, and
//     the polyphase inner loops unrolled; one instantiation takes any other
//     pair at run time.
//   * The stage-1 outputs are phase-major too (row p2 holds outputs g*R2 +
//     p2), rows padded as the window's, so that stage 1's stores and stage
//     2's reads fall in 32 banks. Stage 2 runs once a batch of chunks (256 /
//     q2 of them), one thread an output.
//   * Bound: device-memory bytes. 8 B per f32 IQ sample in (4 for int16), the
//     final rate out, about 20 multiply-adds and one sincosf per input
//     sample.
//
// Single-stage mode is R2 = 1, J2 = 0 with a stage-2 tap of 1.0 (exact).
// int16 input is ADC counts; the 2^-15 scale is folded into the stage-1 taps.

#include <cstdint>
#include <cuda_runtime.h>

#include "frontend.cuh"

namespace {

using rf::kAsync;
using rf::kBulk;
using rf::kCopyGather;
using rf::kGather;
using rf::kPair;
using rf::kThreads;
using rf::Layout;

struct Args {
  const void* xr;
  const void* xi;
  long long ch_stride, t_stride;  // elements
  const float2* tail;             // (C, Hc) raw samples before the block
  const int* words;
  const int* acc;
  const float* w1;  // (J0 + 1, R1) padded polyphase taps
  const float* w2;  // (J2 + 1, R2)
  float2* y;        // (C, T / (R1 R2))
  float* pow_part;  // (C, strips)
  int C, T, R1, J0, R2, J2, q2, per_strip, chunks, strips, stages, form, copy, width;
  float scale;
};

template <typename Tin, int kR1, int kR2>
__global__ void __launch_bounds__(kThreads)
fused_frontend2_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R1 = kR1 ? kR1 : a.R1;
  const int R2 = kR2 ? kR2 : a.R2;
  const int J0 = a.J0, J2 = a.J2;
  const int D = R1 * R2;
  const int M2 = a.T / D;
  const int Hc = J2 * D + J0 * R1;
  const int strip = blockIdx.x, c = blockIdx.y;
  const int k0 = strip * a.per_strip;
  const int nk = (a.chunks < k0 + a.per_strip ? a.chunks : k0 + a.per_strip) - k0;
  const int n1 = a.q2 * R2;  // stage-1 outputs a chunk
  const Layout l = rf::layout(R1, J0, R2, J2, a.q2, a.stages, a.form, sizeof(Tin));

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + l.bars;
  float* sw1 = reinterpret_cast<float*>(ring + a.stages * l.stage);  // 16-byte aligned
  float* sw2 = sw1 + l.taps1;
  float* red = sw2 + l.taps2;
  float* sxr = red + kThreads / 32;  // [R1][nf] mixed window
  float* sxi = sxr + R1 * l.nf;
  float* s1r = sxi + R1 * l.nf;  // [R2][nf2] stage-1 outputs
  float* s1i = s1r + R2 * l.nf2;

  for (int k = threadIdx.x; k < (J0 + 1) * R1; k += kThreads) sw1[k] = a.w1[k];
  for (int k = threadIdx.x; k < (J2 + 1) * R2; k += kThreads) sw2[k] = a.w2[k];
  rf::init_ring(bars, a.stages, a.copy);
  __syncthreads();

  const Tin* xr = static_cast<const Tin*>(a.xr) + c * a.ch_stride;
  const Tin* xi = static_cast<const Tin*>(a.xi) + c * a.ch_stride;
  const rf::Strip<Tin, Args> st{a, l, xr, xi, ring, bars, k0, a.q2 * D};

  auto mix = [&](uint32_t theta, int e, int f0, float re, float im) {
    float s, co;
    rf::oscillator(theta, a.scale, s, co);
    rf::mix_store(sxr, sxi, l.nf, R1, e, f0, re, im, s, co);
  };
  // stage 1 over frames [0, count + J0) of the window: output i to frame
  // g0 + i / R2 of stage-1 row i % R2
  auto stage1 = [&](int count, int g0) {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const float2 v = rf::polyphase<kR1>(sw1, sxr, sxi, l.nf, R1, J0, i);
      const int g = i / R2;
      const int p2 = i - g * R2;
      s1r[p2 * l.nf2 + g0 + g] = v.x;
      s1i[p2 * l.nf2 + g0 + g] = v.y;
    }
  };
  // stage 2 over `count` outputs from stage-1 frame 0, the first output
  // q0; one thread an output, its taps in (j, p) order as stage 1's
  auto stage2 = [&](int count, long long q0) {
    for (int q = threadIdx.x; q < count; q += kThreads) {
      float ar = 0.f, ai = 0.f;
      for (int j = 0; j <= J2; ++j) {
#pragma unroll
        for (int p2 = 0; p2 < R2; ++p2) {  // a constant trip count but for kR2 = 0
          const float w = sw2[j * R2 + p2];
          ar = fmaf(w, s1r[p2 * l.nf2 + q + j], ar);
          ai = fmaf(w, s1i[p2 * l.nf2 + q + j], ai);
        }
      }
      if (q0 + q < M2) a.y[static_cast<long long>(c) * M2 + q0 + q] = make_float2(ar, ai);
    }
  };

  // the prologue's Hc samples fill frames [0, J0 + J2 R2); stage 1 over
  // them fills stage 2's history
  auto prologue = [&] {
    stage1(J2 * R2, 0);
    __syncthreads();
    rf::move_front(sxr, sxi, R1, l.nf, J2 * R2, J0);
    __syncthreads();
  };
  int filled = 0;  // chunks whose stage-1 outputs wait for stage 2
  auto body = [&](int i) {
    stage1(n1, J2 + filled * a.q2);
    __syncthreads();
    rf::move_front(sxr, sxi, R1, l.nf, n1, J0);  // stage 1 is done with the window
    if (++filled == l.batch || i == nk - 1) {  // stage 2 over the batch's outputs
      stage2(filled * a.q2, static_cast<long long>(k0 + i + 1 - filled) * a.q2);
      __syncthreads();
      rf::move_front(s1r, s1i, R2, l.nf2, filled * a.q2, J2);
      filled = 0;
    }
  };
  const float pw = rf::walk(a, st, c, nk, Hc, J0, mix, [&](int i) { st.issue(i); }, prologue,
                            body);
  rf::store_power(pw, red, a.pow_part + static_cast<long long>(c) * a.strips + strip);
}

template <typename Tin, int kR1, int kR2>
cudaError_t resident(int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_frontend2_kernel<Tin, kR1, kR2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_frontend2_kernel<Tin, kR1, kR2>, kThreads, smem);
  *blocks = sms * per_sm;
  return e;
}

template <typename Tin, int kR1, int kR2>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_frontend2_kernel<Tin, kR1, kR2>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fused_frontend2_kernel<Tin, kR1, kR2><<<dim3(a.strips, a.C), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for (R1, R2): the chains' pairs at compile time, any
// other at run time.
template <typename Tin>
cudaError_t resident_any(int R1, int R2, int smem, int* blocks) {
  if (R1 == 8 && R2 == 4) return resident<Tin, 8, 4>(smem, blocks);
  if (R1 == 8 && R2 == 1) return resident<Tin, 8, 1>(smem, blocks);
  if (R1 == 2 && R2 == 2) return resident<Tin, 2, 2>(smem, blocks);
  return resident<Tin, 0, 0>(smem, blocks);
}
template <typename Tin>
cudaError_t launch_any(const Args& a, int smem, cudaStream_t s) {
  if (a.R1 == 8 && a.R2 == 4) return launch<Tin, 8, 4>(a, smem, s);
  if (a.R1 == 8 && a.R2 == 1) return launch<Tin, 8, 1>(a, smem, s);
  if (a.R1 == 2 && a.R2 == 2) return launch<Tin, 2, 2>(a, smem, s);
  return launch<Tin, 0, 0>(a, smem, s);
}

template <typename Tin>
int run(const Tin* xr, const Tin* xi, long long ch_stride, long long t_stride, const void* tail,
        const int* words, const int* acc, const float* w1, const float* w2, void* y,
        float* pow_part, int C, int T, int R1, int J0, int R2, int J2, int q2, int per_strip,
        int strips, int stages, int form, int copy, int width, int smem, float scale,
        void* stream) {
  const int D = R1 * R2;
  const Layout l = rf::layout(R1, J0, R2, J2, q2, stages, form, sizeof(Tin));
  const int chunks = q2 > 0 && D > 0 ? (T / D + q2 - 1) / q2 : 0;
  const bool ok = D > 0 && T % D == 0 && q2 >= J2 && q2 * R2 >= J0 && stages >= 1 &&
                  strips >= 1 && per_strip >= 1 && (strips - 1) * per_strip < chunks &&
                  strips * per_strip >= chunks && l.smem == smem && form >= kPair &&
                  form <= kGather && (form == kGather) == (copy == kCopyGather) &&
                  (copy != kAsync || width == 4 || width == 8);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xr, xi, ch_stride, t_stride, static_cast<const float2*>(tail), words, acc, w1,
               w2, static_cast<float2*>(y), pow_part, C, T, R1, J0, R2, J2, q2, per_strip,
               chunks, strips, stages, form, copy, width, scale};
  return static_cast<int>(launch_any<Tin>(a, smem, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Blocks of the (int16 or f32, R1, R2) kernel the card keeps resident at
// `smem` bytes of dynamic shared memory, for the plan's strips
// (kernels/frontend_plan.py). Returns the CUDA error.
int rf_fused_frontend2_resident(int i16, int R1, int R2, int smem, int* blocks) {
  return static_cast<int>(i16 ? resident_any<int16_t>(R1, R2, smem, blocks)
                              : resident_any<float>(R1, R2, smem, blocks));
}

// Returns cudaGetLastError() after the launch (0 = launched). The plan
// (q2, per_strip, strips, stages, form, copy, width, smem) is
// kernels/frontend_plan.py's; a plan whose layout does not give `smem`
// bytes is refused.
int rf_fused_frontend2_f32(const float* xr, const float* xi, long long ch_stride,
                           long long t_stride, const void* tail, const int* words,
                           const int* acc, const float* w1, const float* w2, void* y,
                           float* pow_part, int C, int T, int R1, int J0, int R2, int J2, int q2,
                           int per_strip, int strips, int stages, int form, int copy, int width,
                           int smem, float scale, void* stream) {
  return run<float>(xr, xi, ch_stride, t_stride, tail, words, acc, w1, w2, y, pow_part, C, T,
                    R1, J0, R2, J2, q2, per_strip, strips, stages, form, copy, width, smem,
                    scale, stream);
}

int rf_fused_frontend2_i16(const int16_t* xr, const int16_t* xi, long long ch_stride,
                           long long t_stride, const void* tail, const int* words,
                           const int* acc, const float* w1, const float* w2, void* y,
                           float* pow_part, int C, int T, int R1, int J0, int R2, int J2, int q2,
                           int per_strip, int strips, int stages, int form, int copy, int width,
                           int smem, float scale, void* stream) {
  return run<int16_t>(xr, xi, ch_stride, t_stride, tail, words, acc, w1, w2, y, pow_part, C, T,
                      R1, J0, R2, J2, q2, per_strip, strips, stages, form, copy, width, smem,
                      scale, stream);
}

}  // extern "C"
