// The load path and strip walk shared by the fused front ends K1
// (fused_frontend2.cu: mix + two polyphase stages + power) and K2
// (fused_frontend.cu: mix + one polyphase stage + power, with K8's cost
// variants). kernels/frontend_plan.py plans the launch and holds a plain
// executor of the same schedule and index maps.
//
//   * Strips. A thread block owns one channel and a strip of consecutive
//     chunks (a chunk is q final-rate outputs, q * D raw samples, D the
//     whole decimation) and walks them in time order. The block carries its
//     mixed history in shared memory from chunk to chunk: the last J0 mixed
//     frames (stage 1's history) move to the front of the window after each
//     chunk, so that after a strip's first chunk no sample is read or mixed
//     twice. A prologue at the strip's start reads the Hc raw samples before
//     it (the carried tail below sample 0) with plain loads and mixes them.
//   * The ring. Raw chunks reach shared memory through `stages` buffers, each
//     guarded by an mbarrier, `stages` chunks in flight while one is mixed
//     and filtered. Three copy paths, one per launch, from the input's
//     alignment: one cp.async.bulk (TMA) per plane and chunk where every
//     address and length is 16-byte aligned; per-thread cp.async of 8 or 4
//     bytes over the byte range rounded out to that width where not (int16
//     rows of an odd length, views with a column offset: the consumer reads
//     past the address's offset in the width); plain loads of a strided view.
//     The interleaved complex input (the view_as_real the chains pass) is one
//     copy of 8-byte samples, split into re/im as it is mixed.
//   * The window is phase-major (row p holds mixed samples f*R + p), rows
//     padded to 32/R mod 32 floats, so that a warp's 32 consecutive samples
//     (the mix's stores) and its 32 consecutive windows (the stage's reads)
//     fall in 32 banks.
//   * Power. Each thread sums xr^2 + xi^2 of the samples it mixes, in raw
//     input units; the block's sum goes to a (C, strips) buffer that the
//     caller sums: deterministic, unlike atomics.
//
// The DDS phase is formed in uint32 (signed overflow is undefined in C++),
// reinterpreted as int32, converted to float, then scaled by -(2 pi) 2^-32:
// the reference's order, so that the angles agree bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rf {

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
  int batch;    // chunks whose stage-1 outputs one stage-2 pass takes (1 without stage 2)
  int nf, nf2;  // row lengths (floats) of the mixed window and of the stage-1 outputs
  int plane;    // bytes of one plane of a ring buffer (pair: the whole buffer)
  int stage;    // bytes of one ring buffer
  int bars;     // bytes of the mbarriers
  int taps1, taps2;  // floats of the two stages' taps (16-byte multiples)
  int smem;     // dynamic shared memory in all
};

// K1's layout with a second stage (R2, J2); K2's (stage2 false) holds no
// stage-2 taps or rows: its stage 1 writes the output.
__host__ __device__ inline Layout layout(int R1, int J0, int R2, int J2, int q2, int stages,
                                         int form, int elt, bool stage2 = true) {
  Layout l{};
  l.batch = stage2 && q2 < kThreads ? kThreads / q2 : 1;
  l.nf = padded_frames(J0 + q2 * R2, R1);
  l.nf2 = stage2 ? padded_frames(J2 + l.batch * q2, R2) : 0;
  const int chunk = q2 * R1 * R2;
  l.plane = form == kPair ? round16(2 * chunk * elt + 16) : round16(chunk * elt + 16);
  l.stage = form == kPair ? l.plane : 2 * l.plane;
  l.bars = round16(8 * stages);
  l.taps1 = round4((J0 + 1) * R1);
  l.taps2 = stage2 ? round4((J2 + 1) * R2) : 0;
  const int floats = l.taps1 + l.taps2 + kThreads / 32 + 2 * R1 * l.nf + 2 * R2 * l.nf2;
  l.smem = l.bars + stages * l.stage + 4 * floats;
  return l;
}

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

// --- the ring ------------------------------------------------------------------------------

// One block's view of its channel's rows and its ring. A is the kernel's
// __grid_constant__ argument struct: xr/xi, t_stride, T, stages, form, copy,
// width are read from it.
template <typename Tin, typename A>
struct Strip {
  const A& a;
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

// The ring's mbarriers: one arrival (the issuing thread's, with its bytes)
// for the bulk path, every thread's for the others. Call before the first
// issue, followed by a block barrier.
__device__ __forceinline__ void init_ring(uint64_t* bars, int stages, int copy) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + s, copy == kBulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

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

// --- the mix and the polyphase stage -------------------------------------------------------

// e^{-j theta} of the DDS phase theta: the precise sincosf. __sincosf (~15%
// faster, its output within 6e-7 of the plain version's) moves the flagship
// chain's audio 5e-4 after its AGC, over the chain's 2e-4 bound.
__device__ __forceinline__ void oscillator(uint32_t theta, float scale, float& s, float& co) {
  const float ang = static_cast<float>(static_cast<int32_t>(theta)) * scale;
  sincosf(ang, &s, &co);
}

// (re + j im) e^{-j theta} stored as sample e of a phase-major window of R
// rows of nf floats: frame f0 + e / R of row e % R. kExact rounds each
// product and sum (no fused multiply-add), as separate elementwise tensor
// ops do on every device; else the compiler contracts them, as PyTorch's
// complex product on the card does (K1's plain version).
template <bool kExact = false>
__device__ __forceinline__ void mix_store(float* sxr, float* sxi, int nf, int R, int e, int f0,
                                          float re, float im, float s, float co) {
  const int f = e / R;
  const int p = e - f * R;
  if constexpr (kExact) {
    sxr[p * nf + f0 + f] = __fsub_rn(__fmul_rn(re, co), __fmul_rn(im, s));
    sxi[p * nf + f0 + f] = __fadd_rn(__fmul_rn(re, s), __fmul_rn(im, co));
  } else {
    sxr[p * nf + f0 + f] = re * co - im * s;
    sxi[p * nf + f0 + f] = re * s + im * co;
  }
}

// One polyphase output: sum over j <= J of w[j, p] win[p][i + j], taps in
// (j, p) order in one accumulator. The plain versions' strided conv1d sums
// in this order, and with the same roundings the chains downstream (whose
// NFM discriminator on weak input magnifies an ulp a thousandfold) see the
// same samples. kR is R at compile time (0: read at run time).
template <int kR>
__device__ __forceinline__ float2 polyphase(const float* sw, const float* wr, const float* wi,
                                            int nf, int R, int J, int i) {
  float ar = 0.f, ai = 0.f;
  for (int j = 0; j <= J; ++j) {
    if constexpr (kR % 4 == 0 && kR > 0) {  // the taps four at a time
#pragma unroll
      for (int p = 0; p < kR; p += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sw + j * kR + p);
        ar = fmaf(w.x, wr[p * nf + i + j], ar);
        ai = fmaf(w.x, wi[p * nf + i + j], ai);
        ar = fmaf(w.y, wr[(p + 1) * nf + i + j], ar);
        ai = fmaf(w.y, wi[(p + 1) * nf + i + j], ai);
        ar = fmaf(w.z, wr[(p + 2) * nf + i + j], ar);
        ai = fmaf(w.z, wi[(p + 2) * nf + i + j], ai);
        ar = fmaf(w.w, wr[(p + 3) * nf + i + j], ar);
        ai = fmaf(w.w, wi[(p + 3) * nf + i + j], ai);
      }
    } else {
#pragma unroll
      for (int p = 0; p < (kR ? kR : R); ++p) {  // a constant trip count but for kR = 0
        const float w = sw[j * R + p];
        ar = fmaf(w, wr[p * nf + i + j], ar);
        ai = fmaf(w, wi[p * nf + i + j], ai);
      }
    }
  }
  return make_float2(ar, ai);
}

// --- the strip walk ------------------------------------------------------------------------

// pw + (re^2 + im^2) with the roundings nvcc gives K1's `pw += re * re +
// im * im` (im^2 fused onto the rounded re^2, then the add), spelled out so
// that the power sums keep those bits whatever code surrounds the walk.
__device__ __forceinline__ float power_add(float pw, float re, float im) {
  return __fadd_rn(pw, __fmaf_rn(im, im, __fmul_rn(re, re)));
}

// The block's walk over its strip of nk chunks (st.k0 the first), after its
// taps are staged and its ring initialized:
//   the prologue mixes the Hc raw samples before the strip (the tail (C, Hc)
//   at negative indices) into frames [0, Hc / R) with mix(theta, e, 0, re,
//   im), then calls prologue();
//   chunk i is awaited, mixed into frames [J0, ...) with mix(theta, e, J0,
//   re, im) (zeros past T), its ring buffer handed to issue(i + stages),
//   then body(i) runs (stage 1 onwards; it ends with the window's history
//   moved to the front) and a block barrier.
// Returns this thread's sum of xr^2 + xi^2 over the strip's samples.
template <typename Tin, typename A, typename Mix, typename Issue, typename Prologue,
          typename Body>
__device__ __forceinline__ float walk(const A& a, const Strip<Tin, A>& st, int c, int nk,
                                      int Hc, int J0, Mix mix, Issue issue, Prologue prologue,
                                      Body body) {
  for (int i = 0; i < a.stages && i < nk; ++i) issue(i);
  const uint32_t word = static_cast<uint32_t>(a.words[c]);
  const uint32_t acc0 = static_cast<uint32_t>(a.acc[c]);
  const int chunk = st.chunk;

  const long long start = static_cast<long long>(st.k0) * chunk - Hc;
  const float2* tc = a.tail + static_cast<long long>(c) * Hc;
  for (int e = threadIdx.x; e < Hc; e += kThreads) {
    const long long n = start + e;
    float re, im;
    if (n < 0) {
      const float2 v = tc[n + Hc];
      re = v.x;
      im = v.y;
    } else {
      re = static_cast<float>(st.xr[n * a.t_stride]);
      im = static_cast<float>(st.xi[n * a.t_stride]);
    }
    mix(acc0 + word * static_cast<uint32_t>(n), e, 0, re, im);
  }
  __syncthreads();
  prologue();

  float pw = 0.f;
  for (int i = 0; i < nk; ++i) {
    const long long n0 = static_cast<long long>(st.k0 + i) * chunk;
    mbar_wait(st.bars + i % a.stages, static_cast<uint32_t>(i / a.stages) & 1u);
    const Tin *br, *bi;
    const int step = st.staged(i, br, bi);
    const int valid = n0 + chunk <= a.T ? chunk : static_cast<int>(a.T - n0);
    const uint32_t theta0 = acc0 + word * static_cast<uint32_t>(n0);
    if (sizeof(Tin) == 4 && step == 2 && (reinterpret_cast<uintptr_t>(br) & 7u) == 0) {
      // interleaved f32: one 8-byte load a sample (two 4-byte loads conflict)
      const float2* b2 = reinterpret_cast<const float2*>(br);
      for (int e = threadIdx.x; e < chunk; e += kThreads) {
        const float2 v = e < valid ? b2[e] : make_float2(0.f, 0.f);
        pw = power_add(pw, v.x, v.y);
        mix(theta0 + word * static_cast<uint32_t>(e), e, J0, v.x, v.y);
      }
    } else {
      for (int e = threadIdx.x; e < chunk; e += kThreads) {
        float re = 0.f, im = 0.f;
        if (e < valid) {
          re = static_cast<float>(br[e * step]);
          im = static_cast<float>(bi[e * step]);
          pw = power_add(pw, re, im);
        }
        mix(theta0 + word * static_cast<uint32_t>(e), e, J0, re, im);
      }
    }
    __syncthreads();  // the window is mixed; ring buffer i % stages is free
    if (i + a.stages < nk) issue(i + a.stages);
    body(i);
    __syncthreads();
  }
  return pw;
}

// The block's power partial (every thread's pw summed) stored at *out.
__device__ __forceinline__ void store_power(float pw, float* red, float* out) {
  for (int off = 16; off > 0; off >>= 1) pw += __shfl_down_sync(0xffffffffu, pw, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = pw;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    *out = s;
  }
}

}  // namespace rf
