// Fused NCO mix + stage-1 polyphase FIR (decimate by R1) + stage-2
// polyphase FIR (decimate by R2) + per-channel input power, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/fused_frontend2.py::_kernel
// (driven by FusedFrontend2.step_planes). Same function, rethought for a GPU:
//
//   * Persistent strips. A thread block owns one channel and a strip of
//     consecutive chunks of q2 final-rate outputs (q2*R1*R2 raw samples),
//     and walks them in time order; the grid is about the card's resident
//     blocks (kernels/frontend_plan.py plans strips, chunks and stages). The
//     TPU kernel carried its mixed history in VMEM across a sequential grid;
//     here the block carries it in shared memory from chunk to chunk: the
//     last J0 mixed frames (stage 1's history) and the last J2 stage-1
//     frames (stage 2's), so that after a strip's first chunk no sample is
//     read or mixed twice. A prologue at the strip's start reads the
//     Hc = J2*R1*R2 + J0*R1 raw samples before it (the carried tail below
//     sample 0) with plain loads, mixes them and runs stage 1 over them.
//   * An asynchronous load path. Raw chunks reach shared memory through a
//     ring of `stages` buffers, each guarded by an mbarrier, with `stages`
//     chunks in flight while one is mixed and filtered (at the flagship's
//     C = 128, T = 131072: 16 KB chunks, three in flight, three blocks an
//     SM). Three copy paths, one per launch, from the input's alignment:
//     one cp.async.bulk (TMA) per plane and chunk where every address and
//     length is 16-byte aligned; per-thread cp.async of 8 or 4 bytes over
//     the byte range rounded out to that width where not (int16 rows
//     of an odd length, views with a column offset: the consumer reads past
//     the address's offset in the width); plain loads of a strided view.
//     The interleaved complex input (the view_as_real the chain passes) is
//     one copy of 8-byte samples, split into re/im as it is mixed.
//   * Decimation at compile time for the pairs the chains build, (R1, R2) =
//     (8, 4), (8, 1) and (2, 2): no integer division in the index maps, and
//     the polyphase inner loops unrolled; one instantiation takes any other
//     pair at run time.
//   * Bank-conflict-free layouts: the mixed window and the stage-1 outputs
//     are phase-major (row p holds samples f*R + p), rows padded to 32/R
//     mod 32 floats, so a warp's 32 consecutive samples (the mix's stores,
//     stage 1's stores) and its 32 consecutive windows (stage 1's and stage
//     2's reads) fall in 32 banks. Stage 2 runs once a batch of chunks
//     (256 / q2 of them), one thread an output.
//   * Bound: device-memory bytes. 8 B per f32 IQ sample in (4 for int16), the
//     final rate out, about 20 multiply-adds and one sincosf per input
//     sample. Per-strip power partials go to a (C, strips) buffer that the
//     caller sums: deterministic, unlike atomics.
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
constexpr int kBanks = 32;
enum Form : int { kPair = 0, kPlanes = 1, kGather = 2 };    // frontend_plan.FORMS
enum Copy : int { kBulk = 0, kAsync = 1, kCopyGather = 2 };  // frontend_plan.COPIES

// --- the shared-memory layout (frontend_plan.smem_bytes) ----------------------------------

__host__ __device__ constexpr int padded_frames(int n, int R) {
  const int target = R <= kBanks && (R & (R - 1)) == 0 ? (kBanks / R) % kBanks : 1;
  return n + ((target - n) % kBanks + kBanks) % kBanks;
}
__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

struct Layout {
  int batch;    // chunks whose stage-1 outputs one stage-2 pass takes
  int nf, nf2;  // row lengths (floats) of the mixed window and of the stage-1 outputs
  int plane;    // bytes of one plane of a ring buffer (pair: the whole buffer)
  int stage;    // bytes of one ring buffer
  int bars;     // bytes of the mbarriers
  int taps1, taps2;  // floats of the two stages' taps (16-byte multiples)
  int smem;     // dynamic shared memory in all
};

__host__ __device__ inline Layout layout(int R1, int J0, int R2, int J2, int q2, int stages,
                                         int form, int elt) {
  Layout l{};
  l.batch = q2 < kThreads ? kThreads / q2 : 1;
  l.nf = padded_frames(J0 + q2 * R2, R1);
  l.nf2 = padded_frames(J2 + l.batch * q2, R2);
  const int chunk = q2 * R1 * R2;
  l.plane = form == kPair ? round16(2 * chunk * elt + 16) : round16(chunk * elt + 16);
  l.stage = form == kPair ? l.plane : 2 * l.plane;
  l.bars = round16(8 * stages);
  l.taps1 = round4((J0 + 1) * R1);
  l.taps2 = round4((J2 + 1) * R2);
  const int floats = l.taps1 + l.taps2 + kThreads / 32 + 2 * R1 * l.nf + 2 * R2 * l.nf2;
  l.smem = l.bars + stages * l.stage + 4 * floats;
  return l;
}

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

// --- mbarriers and asynchronous copies ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// one TMA bulk copy, its completion counted in bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
template <int W>
__device__ __forceinline__ void async_copy(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
               "n"(W)
               : "memory");
}
// bar's arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// nbytes at src, rounded out to W-byte words (frontend_plan.copy_range),
// copied W bytes a thread at a time to dst; the data lands shift(src) in.
template <int W>
__device__ __forceinline__ void async_range(unsigned char* dst, const void* src, int nbytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = s & ~static_cast<uintptr_t>(W - 1);
  const int count = static_cast<int>(((s + nbytes + W - 1) & ~static_cast<uintptr_t>(W - 1)) -
                                     a0) / W;
  for (int j = threadIdx.x; j < count; j += kThreads)
    async_copy<W>(dst + j * W, reinterpret_cast<const void*>(a0 + static_cast<uintptr_t>(j) * W));
}
__device__ __forceinline__ int shift(const void* src, int copy, int width) {
  return copy == kAsync ? static_cast<int>(reinterpret_cast<uintptr_t>(src) & (width - 1)) : 0;
}

// --- the kernel ----------------------------------------------------------------------------

template <typename Tin>
struct Strip {
  const Args& a;  // the kernel's __grid_constant__ parameter
  Layout l;
  const Tin* xr;  // this channel's rows
  const Tin* xi;
  unsigned char* ring;
  uint64_t* bars;
  int k0, chunk;

  __device__ const Tin* src(const Tin* x, long long n0) const { return x + n0 * a.t_stride; }

  // Start the copy of the strip's chunk i into ring buffer i % stages.
  __device__ void issue(int i) const {
    const int s = i % a.stages;
    unsigned char* buf = ring + s * l.stage;
    uint64_t* bar = bars + s;
    const long long n0 = static_cast<long long>(k0 + i) * chunk;
    const int n = static_cast<int>(n0 + chunk <= a.T ? chunk : a.T - n0);
    const int bytes = (a.form == kPair ? 2 : 1) * n * static_cast<int>(sizeof(Tin));
    if (a.copy == kBulk) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar, a.form == kPair ? bytes : 2 * bytes);
        bulk_copy(buf, src(xr, n0), bytes, bar);
        if (a.form != kPair) bulk_copy(buf + l.plane, src(xi, n0), bytes, bar);
      }
    } else if (a.copy == kAsync) {
      for (int p = 0; p < (a.form == kPair ? 1 : 2); ++p) {
        const void* from = src(p ? xi : xr, n0);
        unsigned char* to = buf + p * l.plane;
        if (a.width == 8)
          async_range<8>(to, from, bytes);
        else
          async_range<4>(to, from, bytes);
      }
      async_arrive(bar);
    } else {  // a strided view: plain loads into the planes layout
      Tin* br = reinterpret_cast<Tin*>(buf);
      Tin* bi = reinterpret_cast<Tin*>(buf + l.plane);
      for (int e = threadIdx.x; e < n; e += kThreads) {
        br[e] = xr[(n0 + e) * a.t_stride];
        bi[e] = xi[(n0 + e) * a.t_stride];
      }
      mbar_arrive(bar);
    }
  }

  // Where chunk i's samples sit in its ring buffer (after the wait): sample
  // e at br[e * step], bi[e * step].
  __device__ __forceinline__ int staged(int i, const Tin*& br, const Tin*& bi) const {
    const long long n0 = static_cast<long long>(k0 + i) * chunk;
    const unsigned char* buf = ring + (i % a.stages) * l.stage;
    br = reinterpret_cast<const Tin*>(buf + shift(src(xr, n0), a.copy, a.width));
    if (a.form == kPair) {
      bi = br + 1;
      return 2;
    }
    bi = reinterpret_cast<const Tin*>(buf + l.plane + shift(src(xi, n0), a.copy, a.width));
    return 1;
  }
};

// Front-move rows of a phase-major buffer: row[0..count) = row[from..from+count).
__device__ __forceinline__ void move_front(float* re, float* im, int rows, int stride,
                                           int from, int count) {
  if (count == 0 || from == 0) return;
  if (from >= count) {  // no overlap: every thread
    for (int idx = threadIdx.x; idx < rows * count; idx += kThreads) {
      const int r = idx / count, j = idx - r * count;
      re[r * stride + j] = re[r * stride + from + j];
      im[r * stride + j] = im[r * stride + from + j];
    }
  } else if (threadIdx.x < rows) {  // overlapping: one thread a row, in order
    for (int j = 0; j < count; ++j) {
      re[threadIdx.x * stride + j] = re[threadIdx.x * stride + from + j];
      im[threadIdx.x * stride + j] = im[threadIdx.x * stride + from + j];
    }
  }
}

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
  const int chunk = a.q2 * D;
  const int n1 = a.q2 * R2;  // stage-1 outputs a chunk
  const Layout l = layout(R1, J0, R2, J2, a.q2, a.stages, a.form, sizeof(Tin));

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
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bars + s, a.copy == kBulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const Tin* xr = static_cast<const Tin*>(a.xr) + c * a.ch_stride;
  const Tin* xi = static_cast<const Tin*>(a.xi) + c * a.ch_stride;
  const Strip<Tin> st{a, l, xr, xi, ring, bars, k0, chunk};
  for (int i = 0; i < a.stages && i < nk; ++i) st.issue(i);

  const uint32_t word = static_cast<uint32_t>(a.words[c]);
  const uint32_t acc0 = static_cast<uint32_t>(a.acc[c]);
  // the sample at DDS phase theta, mixed into frame f0 + e / R1 of row e % R1
  auto mix = [&](uint32_t theta, int e, int f0, float re, float im) {
    const float ang = static_cast<float>(static_cast<int32_t>(theta)) * a.scale;
    float s, co;
    // the precise sincosf: __sincosf (~15% faster, its output within 6e-7 of
    // the plain version's) moves the flagship chain's audio 5e-4 after its
    // AGC, over the chain's 2e-4 bound
    sincosf(ang, &s, &co);
    const int f = e / R1;
    const int p = e - f * R1;
    sxr[p * l.nf + f0 + f] = re * co - im * s;
    sxi[p * l.nf + f0 + f] = re * s + im * co;
  };
  // stage 1 over frames [0, count + J0) of the window: output i to frame
  // g0 + i / R2 of stage-1 row i % R2
  // Both stages sum their taps in order, (j, p), in one accumulator: the
  // plain version's strided conv1d does, and with the same roundings the
  // chains downstream (whose NFM discriminator on weak input magnifies an
  // ulp a thousandfold) see the same samples.
  auto stage1 = [&](int count, int g0) {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      float ar = 0.f, ai = 0.f;
      for (int j = 0; j <= J0; ++j) {
        if constexpr (kR1 % 4 == 0 && kR1 > 0) {  // the taps four at a time
#pragma unroll
          for (int p = 0; p < kR1; p += 4) {
            const float4 w = *reinterpret_cast<const float4*>(sw1 + j * kR1 + p);
            ar = fmaf(w.x, sxr[p * l.nf + i + j], ar);
            ai = fmaf(w.x, sxi[p * l.nf + i + j], ai);
            ar = fmaf(w.y, sxr[(p + 1) * l.nf + i + j], ar);
            ai = fmaf(w.y, sxi[(p + 1) * l.nf + i + j], ai);
            ar = fmaf(w.z, sxr[(p + 2) * l.nf + i + j], ar);
            ai = fmaf(w.z, sxi[(p + 2) * l.nf + i + j], ai);
            ar = fmaf(w.w, sxr[(p + 3) * l.nf + i + j], ar);
            ai = fmaf(w.w, sxi[(p + 3) * l.nf + i + j], ai);
          }
        } else {
#pragma unroll
          for (int p = 0; p < R1; ++p) {  // a constant trip count but for kR1 = 0
            const float w = sw1[j * R1 + p];
            ar = fmaf(w, sxr[p * l.nf + i + j], ar);
            ai = fmaf(w, sxi[p * l.nf + i + j], ai);
          }
        }
      }
      const int g = i / R2;
      const int p2 = i - g * R2;
      s1r[p2 * l.nf2 + g0 + g] = ar;
      s1i[p2 * l.nf2 + g0 + g] = ai;
    }
  };

  // stage 2 over `count` outputs from stage-1 frame 0, the first output
  // q0; one thread an output
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

  // the prologue: the Hc raw samples before the strip, mixed into frames
  // [0, J0 + J2 R2); stage 1 over them fills stage 2's history
  const long long start = static_cast<long long>(k0) * chunk - Hc;
  const float2* tc = a.tail + static_cast<long long>(c) * Hc;
  for (int e = threadIdx.x; e < Hc; e += kThreads) {
    const long long n = start + e;
    float re, im;
    if (n < 0) {
      const float2 v = tc[n + Hc];
      re = v.x;
      im = v.y;
    } else {
      re = static_cast<float>(xr[n * a.t_stride]);
      im = static_cast<float>(xi[n * a.t_stride]);
    }
    mix(acc0 + word * static_cast<uint32_t>(n), e, 0, re, im);
  }
  __syncthreads();
  stage1(J2 * R2, 0);
  __syncthreads();
  move_front(sxr, sxi, R1, l.nf, J2 * R2, J0);
  __syncthreads();

  float pw = 0.f;
  int filled = 0;  // chunks whose stage-1 outputs wait for stage 2
  for (int i = 0; i < nk; ++i) {
    const long long n0 = static_cast<long long>(k0 + i) * chunk;
    mbar_wait(bars + i % a.stages, static_cast<uint32_t>(i / a.stages) & 1u);
    const Tin *br, *bi;
    const int step = st.staged(i, br, bi);
    const int valid = n0 + chunk <= a.T ? chunk : static_cast<int>(a.T - n0);
    const uint32_t theta0 = acc0 + word * static_cast<uint32_t>(n0);
    if (sizeof(Tin) == 4 && step == 2 && (reinterpret_cast<uintptr_t>(br) & 7u) == 0) {
      // interleaved f32: one 8-byte load a sample (two 4-byte loads conflict)
      const float2* b2 = reinterpret_cast<const float2*>(br);
      for (int e = threadIdx.x; e < chunk; e += kThreads) {
        const float2 v = e < valid ? b2[e] : make_float2(0.f, 0.f);
        pw += v.x * v.x + v.y * v.y;
        mix(theta0 + word * static_cast<uint32_t>(e), e, J0, v.x, v.y);
      }
    } else {
      for (int e = threadIdx.x; e < chunk; e += kThreads) {
        float re = 0.f, im = 0.f;
        if (e < valid) {
          re = static_cast<float>(br[e * step]);
          im = static_cast<float>(bi[e * step]);
          pw += re * re + im * im;
        }
        mix(theta0 + word * static_cast<uint32_t>(e), e, J0, re, im);
      }
    }
    __syncthreads();  // the window is mixed; ring buffer i % stages is free
    if (i + a.stages < nk) st.issue(i + a.stages);
    stage1(n1, J2 + filled * a.q2);
    __syncthreads();
    move_front(sxr, sxi, R1, l.nf, n1, J0);  // stage 1 is done with the window
    if (++filled == l.batch || i == nk - 1) {  // stage 2 over the batch's outputs
      stage2(filled * a.q2, static_cast<long long>(k0 + i + 1 - filled) * a.q2);
      __syncthreads();
      move_front(s1r, s1i, R2, l.nf2, filled * a.q2, J2);
      filled = 0;
    }
    __syncthreads();
  }

  for (int off = 16; off > 0; off >>= 1) pw += __shfl_down_sync(0xffffffffu, pw, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = pw;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    a.pow_part[static_cast<long long>(c) * a.strips + strip] = s;
  }
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
  const Layout l = layout(R1, J0, R2, J2, q2, stages, form, sizeof(Tin));
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
