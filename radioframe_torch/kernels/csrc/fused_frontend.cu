// Fused NCO mix + one real-tap polyphase FIR decimating by R + per-channel
// input power, for Hopper, with the cost-decomposition variants of the same
// kernel.
//
// Replaces the Pallas TPU kernel radioframe/kernels/fused_frontend.py::_kernel
// (driven by FusedFrontend.step) and, through the template argument V, the
// probe kernels of tools/probe_fused.py::_mk_kernel. Function:
//
//   y[c, m] = sum_k wp[k] x[c, mR - H + k] e^{-j theta(mR - H + k)},
//   theta(n) = (acc + word n) mod 2^32, n < 0 read from the raw tail (C, H),
//   power[c] = sum_n xr[c, n]^2 + xi[c, n]^2 (raw input units).
//
// The mix rounds each product and sum, as the plain version's separate
// elementwise ops do on the card and on the CPU, so that the kernel, the
// plain version and kernels/frontend_plan.py's executor agree bit for bit.
//
// Rethought for a GPU on K1's load path (frontend.cuh): a block walks a strip
// of chunks of q outputs (q R raw samples; 2048 at the flagship's R = 8: 256
// outputs, one a thread) through a ring of TMA or cp.async buffers guarded by
// mbarriers, carries the last J0 mixed frames in shared memory from chunk to
// chunk, and reads raw halo only in a strip's prologue. Its one stage writes
// y (C, T/R) directly, one thread an output: no stage-2 rows or batch. The
// input power is summed as the samples are mixed (the chains' power_in costs
// no second pass). R = 8 is fixed at compile time; any other R is read at run
// time. Bound: device-memory bytes (8 B in per f32 IQ sample, 8 B out per
// output) against about 6 flops and a sincosf per input sample and 4 per tap
// per output.
//
// Variants (the TPU probe's, each computing what it computed there):
//   kFull     the kernel itself;
//   kNoOsc    oscillator replaced by the constants cos = 0.6, sin = 0.8;
//   kNoTr     each probe tile's (C, W = 128 R) input block read as if it were
//             time-major (128, R, C), the probe's "no transpose" (wrong values,
//             same bytes); the H-sample halo read as it is. Planned as strips
//             of one chunk, the tile, each with its prologue, on the gather
//             copy path (the block's own permuted loads);
//   kOscOnly  y[m] = sum over the R samples from mR - H of the oscillator;
//   kCopyOnly y[m] = sum over the R samples from mR of the input (no mix).
// But for kNoTr an output's value depends on nothing but m, so every plan
// gives the same bits; the power is the full variant's alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "frontend.cuh"

namespace {

using rf::kAsync;
using rf::kCopyGather;
using rf::kGather;
using rf::kPair;
using rf::kThreads;
using rf::Layout;

enum Variant : int { kFull = 0, kNoOsc = 1, kNoTr = 2, kOscOnly = 3, kCopyOnly = 4 };
constexpr int kProbeTile = 128;  // outputs per tile of the probe's no_tr read (its TM)

struct Args {
  const void* xr;
  const void* xi;
  long long ch_stride, t_stride;  // elements
  const float2* tail;             // (C, H) raw samples before the block
  const int* words;
  const int* acc;
  const float* w;   // (J0 + 1, R) padded polyphase taps
  float2* y;        // (C, T / R)
  float* pow_part;  // (C, strips)
  int C, T, R, J0, q, per_strip, chunks, strips, stages, form, copy, width;
  float scale;
};

__host__ __device__ inline Layout k2_layout(int R, int J0, int q, int stages, int form) {
  return rf::layout(R, J0, 1, 0, q, stages, form, sizeof(float), false);
}

template <int V, int kR>
__global__ void __launch_bounds__(kThreads)
fused_frontend_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = kR ? kR : a.R;
  const int J0 = a.J0;
  const int M = a.T / R;
  const int strip = blockIdx.x, c = blockIdx.y;
  const int k0 = strip * a.per_strip;
  const int nk = (a.chunks < k0 + a.per_strip ? a.chunks : k0 + a.per_strip) - k0;
  const int chunk = a.q * R;
  const Layout l = k2_layout(R, J0, a.q, a.stages, a.form);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + l.bars;
  float* sw = reinterpret_cast<float*>(ring + a.stages * l.stage);  // 16-byte aligned
  float* red = sw + l.taps1;
  float* sxr = red + kThreads / 32;  // [R][nf] mixed window
  float* sxi = sxr + R * l.nf;

  for (int k = threadIdx.x; k < (J0 + 1) * R; k += kThreads) sw[k] = a.w[k];
  rf::init_ring(bars, a.stages, a.copy);
  __syncthreads();

  const float* xr = static_cast<const float*>(a.xr) + c * a.ch_stride;
  const float* xi = static_cast<const float*>(a.xi) + c * a.ch_stride;
  const rf::Strip<float, Args> st{a, l, xr, xi, ring, bars, k0, chunk};

  auto mix = [&](uint32_t theta, int e, int f0, float re, float im) {
    if constexpr (V == kCopyOnly || V == kOscOnly) {
      float s = 0.f, co = 0.f;
      if constexpr (V == kOscOnly) rf::oscillator(theta, a.scale, s, co);
      const int f = e / R;
      const int p = e - f * R;
      sxr[p * l.nf + f0 + f] = V == kOscOnly ? co : re;
      sxi[p * l.nf + f0 + f] = V == kOscOnly ? s : im;
    } else {
      float s = 0.8f, co = 0.6f;
      if constexpr (V != kNoOsc) rf::oscillator(theta, a.scale, s, co);
      rf::mix_store<true>(sxr, sxi, l.nf, R, e, f0, re, im, s, co);
    }
  };
  // The probe's no_tr read of tile k0 + i (strips of one chunk): element e
  // of the tile is element (e C + c) of the (C, W) block read flat.
  auto issue_no_tr = [&](int i) {
    const int s = i % a.stages;
    float* br = reinterpret_cast<float*>(ring + s * l.stage);
    float* bi = reinterpret_cast<float*>(ring + s * l.stage + l.plane);
    const long long W = chunk;
    const float* base_r = static_cast<const float*>(a.xr);
    const float* base_i = static_cast<const float*>(a.xi);
    for (int e = threadIdx.x; e < chunk; e += kThreads) {
      const long long q = static_cast<long long>(e) * a.C + c;
      const long long row = q / W;
      const long long at = row * a.ch_stride + ((k0 + i) * W + (q - row * W)) * a.t_stride;
      br[e] = base_r[at];
      bi[e] = base_i[at];
    }
    rf::mbar_arrive(bars + s);
  };
  auto issue = [&](int i) {
    if constexpr (V == kNoTr)
      issue_no_tr(i);
    else
      st.issue(i);
  };
  // one thread an output of the chunk: y[m0 + t] from frames [t, t + J0]
  auto body = [&](int i) {
    const long long m0 = static_cast<long long>(k0 + i) * a.q;
    for (int t = threadIdx.x; t < a.q && m0 + t < M; t += kThreads) {
      float2 v;
      if constexpr (V == kOscOnly || V == kCopyOnly) {
        const int f = V == kOscOnly ? t : t + J0;  // the frame of sample mR - H, or of mR
        float ar = 0.f, ai = 0.f;
        for (int p = 0; p < R; ++p) {
          ar += sxr[p * l.nf + f];
          ai += sxi[p * l.nf + f];
        }
        v = make_float2(ar, ai);
      } else {
        v = rf::polyphase<kR>(sw, sxr, sxi, l.nf, R, J0, t);
      }
      a.y[static_cast<long long>(c) * M + m0 + t] = v;
    }
    __syncthreads();
    rf::move_front(sxr, sxi, R, l.nf, a.q, J0);  // the stage is done with the window
  };
  const float pw = rf::walk(a, st, c, nk, J0 * R, J0, mix, issue, [] {}, body);
  rf::store_power(pw, red, a.pow_part + static_cast<long long>(c) * a.strips + strip);
}

template <int V, int kR>
cudaError_t resident(int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_frontend_kernel<V, kR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_frontend_kernel<V, kR>,
                                                      kThreads, smem);
  *blocks = sms * per_sm;
  return e;
}

template <int V, int kR>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_frontend_kernel<V, kR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fused_frontend_kernel<V, kR><<<dim3(a.strips, a.C), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for (variant, R): R = 8 at compile time, any other R at
// run time.
template <int V>
cudaError_t resident_r(int R, int smem, int* blocks) {
  return R == 8 ? resident<V, 8>(smem, blocks) : resident<V, 0>(smem, blocks);
}
template <int V>
cudaError_t launch_r(const Args& a, int smem, cudaStream_t s) {
  return a.R == 8 ? launch<V, 8>(a, smem, s) : launch<V, 0>(a, smem, s);
}

}  // namespace

extern "C" {

// Blocks of the (variant, R) kernel the card keeps resident at `smem` bytes
// of dynamic shared memory, for the plan's strips (kernels/frontend_plan.py).
// Returns the CUDA error, or cudaErrorInvalidValue for an unknown variant.
int rf_fused_frontend_resident(int variant, int R, int smem, int* blocks) {
  switch (variant) {
    case kFull: return static_cast<int>(resident_r<kFull>(R, smem, blocks));
    case kNoOsc: return static_cast<int>(resident_r<kNoOsc>(R, smem, blocks));
    case kNoTr: return static_cast<int>(resident_r<kNoTr>(R, smem, blocks));
    case kOscOnly: return static_cast<int>(resident_r<kOscOnly>(R, smem, blocks));
    case kCopyOnly: return static_cast<int>(resident_r<kCopyOnly>(R, smem, blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns cudaGetLastError() after the launch (0 = launched). The plan
// (q, per_strip, strips, stages, form, copy, width, smem) is
// kernels/frontend_plan.py's (stage2 off); a plan whose layout does not give
// `smem` bytes, or a no_tr plan that is not one gathered probe tile a strip,
// is refused with cudaErrorInvalidValue, as is an unknown variant.
int rf_fused_frontend(const float* xr, const float* xi, long long ch_stride, long long t_stride,
                      const void* tail, const int* words, const int* acc, const float* w,
                      void* y, float* pow_part, int C, int T, int R, int J0, int q,
                      int per_strip, int strips, int stages, int form, int copy, int width,
                      int smem, int variant, float scale, void* stream) {
  const int chunks = q > 0 && R > 0 ? (T / R + q - 1) / q : 0;
  const bool ok = R > 0 && T % R == 0 && q >= J0 && stages >= 1 && strips >= 1 &&
                  per_strip >= 1 && (strips - 1) * per_strip < chunks &&
                  strips * per_strip >= chunks &&
                  k2_layout(R, J0, q, stages, form).smem == smem && form >= kPair &&
                  form <= kGather && (form == kGather) == (copy == kCopyGather) &&
                  (copy != kAsync || width == 4 || width == 8) &&
                  (variant != kNoTr || (per_strip == 1 && q == kProbeTile &&
                                        copy == kCopyGather && T % (q * R) == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xr, xi, ch_stride, t_stride, static_cast<const float2*>(tail), words, acc, w,
               static_cast<float2*>(y), pow_part, C, T, R, J0, q, per_strip, chunks, strips,
               stages, form, copy, width, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return static_cast<int>(launch_r<kFull>(a, smem, s));
    case kNoOsc: return static_cast<int>(launch_r<kNoOsc>(a, smem, s));
    case kNoTr: return static_cast<int>(launch_r<kNoTr>(a, smem, s));
    case kOscOnly: return static_cast<int>(launch_r<kOscOnly>(a, smem, s));
    case kCopyOnly: return static_cast<int>(launch_r<kCopyOnly>(a, smem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
