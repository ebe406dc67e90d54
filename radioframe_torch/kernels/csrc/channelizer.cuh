// Device code shared by the channelizer kernels (pfb_dft.cu, demod_agc.cu,
// channelizer_one.cu) and the flagship back end (ols_demod.cu): the M-point
// FFT, the polyphase stage (the column walk, rf::PfbColumns, and its
// cluster step for K3; the frame-by-frame rf::pfb_frame for K5), the
// per-element demod value, the per-channel AGC walk, a one-shot grid barrier
// and the launch and occupancy helpers. Everything is in channel order
// (channel c at +c*fs/M); planes are frame-major (F, M), so neighbouring
// threads touch neighbouring channels.
//
// The polyphase stage reads each input sample from device memory once per
// run of frames: a thread walks 2 columns down the frames with its taps and
// the K - 1 frames of history at hand, where the frame-by-frame stage read K
// frames and the taps for every frame through L2 (537 MB of loads and 268 MB
// of taps for 67 MB of input at M = 4096, F = 2048). In K3 a cluster of 8
// CTAs shares the work: each CTA walks M/8 columns and stores each frame's
// columns into the shared memory of the CTA whose FFT takes that frame.
// Measured by chip_smoke.py on an H100 SXM (700 W; PERF.md): K3 0.12 ms
// against the frame-by-frame stage's 0.16 in the same run, K9's pfb_only
// 0.06 against 0.11 (the 0.040 ms byte bound); 128 registers, two CTAs an
// SM, 30 clusters of 8 resident.
//
// The FFT (rf::fft), one function for K3, K5, K6 and K9. What bounds it on
// the H100 is not arithmetic (5 N log2 N flops are nothing next to 67
// TFLOP/s FP32) but shared memory: a radix-2 FFT in shared memory makes
// log2 N round trips of every point, each ended by a block barrier. This one
// is a register-resident mixed-radix Stockham FFT. For N >= 16 each of
// T = N/16 threads holds 16 points in registers and runs radix-16 butterflies
// there (internal twiddles are compile-time constants); the points cross
// shared memory only between passes, through a buffer padded by one word in
// 16, so that no half-warp's 8-byte accesses share a bank. The plan is one
// radix 2^(log2 N mod 4) pass (when that is not 1) and then radix-16 passes:
// N = 4096 is three passes, two exchanges and four barriers (against twelve
// passes and barriers), N = 1024 is 4·16·16. Natural order in and out: thread
// t owns elements t + T m (m < 16) of the input and of the output, so the
// caller loads and stores them coalesced, and K6 feeds one transform's output
// to the next without an exchange. Pass twiddles are e^{-2 pi i 2^b k / L}
// (b < 4) per pass, built in float64 on the host (kernels/fft_plan.py, which
// also holds a plain executor of the same index maps), staged once per block
// in shared memory; a thread forms the other powers by products. Measured by
// chip_smoke.py on an H100 SXM (700 W): 2048 frames of 4096 points in
// 0.058 ms, 69% of the 0.040 ms byte bound (torch.fft.fft 0.052 ms on the
// same planes); 126 registers a thread hold it to two 256-thread blocks per
// SM, so a block's load, three passes and store do not overlap much.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace rf {

enum Mode : int { kSSB = 0, kCW = 1, kAM = 2, kNFM = 3, kLSB = 4 };
constexpr float kDcPole = 0.995f;  // AM DC-block pole (ops/demod.py DC_POLE)
// What the per-channel walk does after the demod (kernels/demod_agc.py
// AGC_OFF, AGC_APPLY, AGC_EMIT_ENV): nothing (demod only); the release,
// attack and gain; or the release alone, its env stored per frame.
enum Agc : int { kAgcOff = 0, kAgcApply = 1, kAgcEmitEnv = 2 };

__device__ __forceinline__ bool enabled(int en, int mode) { return (en >> mode) & 1; }

// --- the FFT ------------------------------------------------------------------------------

constexpr int kFftP = 16;  // points per thread; the radix of every pass after the first

__host__ __device__ constexpr int fft_smem(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int fft_threads(int N) { return N < kFftP ? 1 : N / kFftP; }
// float2 words of one frame's exchange buffer
__host__ __device__ constexpr int fft_exchange_points(int N) { return N + N / 16; }

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n >> 1); }
__host__ __device__ constexpr int first_radix(int N) {
  return N < kFftP ? N : (ilog2(N) % 4 ? 1 << (ilog2(N) % 4) : kFftP);
}
// float2 words of the twiddle table: 4 Ns for every pass after the first
__host__ __device__ constexpr int fft_twiddle_points(int N) {
  int n = 0;
  for (int ns = first_radix(N); ns < N; ns *= kFftP) n += 4 * ns;
  return N < kFftP ? 0 : n;
}

__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}
__host__ __device__ constexpr int high_bit(int r) { return 1 << ilog2(r); }

// cos and sin of 2 pi k / 16, k < 8
__host__ __device__ constexpr float cos16(int k) {
  return k == 0 ? 1.f : k == 1 ? 0.923879532511286756f : k == 2 ? 0.707106781186547524f
       : k == 3 ? 0.382683432365089772f : k == 4 ? 0.f : k == 5 ? -0.382683432365089772f
       : k == 6 ? -0.707106781186547524f : -0.923879532511286756f;
}
__host__ __device__ constexpr float sin16(int k) { return cos16(k < 4 ? 4 - k : k - 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// x e^{-2 pi i k / 16}; k is a constant once the caller's loops are unrolled
__device__ __forceinline__ float2 rot16(int k, float2 x) {
  if (k == 0) return x;
  if (k == 4) return make_float2(x.y, -x.x);
  const float c = cos16(k), s = sin16(k);
  return make_float2(fmaf(x.x, c, x.y * s), fmaf(x.y, c, -x.x * s));
}

// In-register R-point DFT of v[o], ..., v[o + R - 1], natural order in and
// out: radix-2 decimation in frequency, then the bit reversal as a renaming.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[kFftP], int o) {
#pragma unroll
  for (int stage = 0; stage < ilog2(R); ++stage) {  // a counted loop, so that it unrolls
    const int half = R >> (stage + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i & half) == 0) {
        const float2 a = v[o + i], b = v[o + i + half];
        v[o + i] = make_float2(a.x + b.x, a.y + b.y);
        v[o + i + half] = rot16((i & (half - 1)) * (8 / half), make_float2(a.x - b.x, a.y - b.y));
      }
    }
  }
  float2 u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = v[o + i];
#pragma unroll
  for (int i = 0; i < R; ++i) v[o + i] = u[bit_reverse(i, ilog2(R))];
}

// The first pass (Ns = 1): Q butterflies per thread (Q R points), butterfly
// j = t + T q reading elements j + r N / R, i.e. v[q + Q r]; then, unless it
// is the only pass, its outputs go to the exchange buffer at j R + r.
template <int R, int Q>
__device__ __forceinline__ void fft_first(float2 (&v)[kFftP], float2* buf, int t, int T,
                                          bool last) {
  float2 u[kFftP];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) u[q * R + r] = v[q + Q * r];
#pragma unroll
  for (int q = 0; q < Q; ++q) dft<R>(u, q * R);
  if (last) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = u[r];
    return;
  }
  __syncthreads();  // the buffer's last readers (the previous transform) are done
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) buf[fft_smem((t + T * q) * R + r)] = u[q * R + r];
}

// Forward DFT of one N-point frame (N a power of two >= 2) held by its
// fft_threads(N) threads: on entry v[m] = x[t + T m], on return
// v[m] = X[t + T m] = sum_n x[n] e^{-2 pi i n (t + T m) / N}, m < min(N, 16).
// buf: this frame's exchange buffer (fft_exchange_points(N) words); tw: the
// twiddle table in shared memory. Every thread of the block calls it with
// the same N (it holds block barriers); a thread whose frame is out of range
// computes on whatever it holds and stores nothing.
__device__ __forceinline__ void fft(float2 (&v)[kFftP], float2* buf, const float2* tw, int N,
                                    int t) {
  if (N < kFftP) {  // one thread, one pass, no exchange
    switch (N) {
      case 2: fft_first<2, 1>(v, buf, 0, 1, true); break;
      case 4: fft_first<4, 1>(v, buf, 0, 1, true); break;
      default: fft_first<8, 1>(v, buf, 0, 1, true); break;
    }
    return;
  }
  const int T = N / kFftP;
  const int r0 = first_radix(N);
  const bool one = r0 == N;
  switch (r0) {
    case 2: fft_first<2, 8>(v, buf, t, T, one); break;
    case 4: fft_first<4, 4>(v, buf, t, T, one); break;
    case 8: fft_first<8, 2>(v, buf, t, T, one); break;
    default: fft_first<16, 1>(v, buf, t, T, one); break;
  }
  int off = 0;
  for (int ns = r0; ns < N; ns *= kFftP) {  // radix-16 passes, one butterfly per thread
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kFftP; ++s) v[s] = buf[fft_smem(t + T * s)];
    const int k = t & (ns - 1);
    float2 w[kFftP];
#pragma unroll
    for (int b = 0; b < 4; ++b) w[1 << b] = tw[off + b * ns + k];
#pragma unroll
    for (int r = 3; r < kFftP; ++r)
      if (r != high_bit(r)) w[r] = cmul(w[high_bit(r)], w[r - high_bit(r)]);
#pragma unroll
    for (int r = 1; r < kFftP; ++r) v[r] = cmul(v[r], w[r]);
    off += 4 * ns;
    dft<kFftP>(v, 0);
    if (ns * kFftP < N) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kFftP; ++r) buf[fft_smem((t - k) * kFftP + k + r * ns)] = v[r];
    }
  }
}

// Copy the twiddle table into shared memory (every thread of the block).
__device__ __forceinline__ void stage_twiddles(float2* dst, const float2* __restrict__ tw, int N) {
  for (int i = threadIdx.x; i < fft_twiddle_points(N); i += blockDim.x) dst[i] = tw[i];
  __syncthreads();
}

// --- the polyphase stage: a walk down each point's column ---------------------------------
//
// u[f][p] = sum_{k < K} h[k][p] x(f - k)[p], k = 0 first, one fmaf a tap (the
// sum order of the stage this replaced, so its outputs keep their bits).
// Frames before 0 come from the carried tail. A thread owns P points
// (columns) and walks them down the frames in time order, Q frames a step:
// its K taps of each point and the window of its columns (the K - 1 frames
// before the step, then the Q of the step) live in registers, so each input
// sample is loaded from device memory once per run of frames and each tap
// once per launch. A run's first step loads the K - 1 frames before it (the
// only re-read: (K - 1) / run length of the input); later steps shift the
// window. KW, the window's tap capacity (8 or 16), is a compile-time bound
// on the runtime K. A lane that walks Q frames out of a longer step (K3 and
// K5 at M < 512) reloads its history every step.

constexpr int kPfbPoints = 2;  // P, columns a thread walks
constexpr int kPfbFrames = 8;  // Q, frames a thread takes a step
constexpr int kPfbCluster = 8;  // CTAs of a polyphase cluster (the portable most)

template <int KW>
struct PfbColumns {
  static constexpr int P = kPfbPoints, Q = kPfbFrames, H = KW - 1;
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  long long xs;
  const float2* __restrict__ tail;
  int M, K;
  int p[P];
  float h[KW][P];
  float2 w[H + Q][P];  // w[0..H-1]: frames f-H..f-1 of the step at f; w[H + q]: frame f + q

  // this thread's columns p0 + i * stride, i < P; the taps loaded once
  __device__ __forceinline__ PfbColumns(const float* __restrict__ xr_,
                                        const float* __restrict__ xi_, long long xs_,
                                        const float2* __restrict__ tail_,
                                        const float* __restrict__ taps, int M_, int K_, int p0,
                                        int stride)
      : xr(xr_), xi(xi_), xs(xs_), tail(tail_), M(M_), K(K_) {
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = p0 + i * stride;
#pragma unroll
    for (int k = 0; k < KW; ++k)
#pragma unroll
      for (int i = 0; i < P; ++i) h[k][i] = k < K ? __ldg(taps + k * M + p[i]) : 0.f;
  }

  // sample g of column pi: the input for g >= 0, the tail for -(K-1) <= g < 0
  __device__ __forceinline__ float2 sample(long long g, int pi) const {
    if (g >= 0) {
      const long long n = (g * M + pi) * xs;
      return make_float2(__ldg(xr + n), __ldg(xi + n));
    }
    if (g >= 1 - K) return __ldg(tail + (K - 1 + g) * M + pi);
    return make_float2(0.f, 0.f);
  }

  // the step at frame f: its Q frames, and with `history` the H frames
  // before it (else they were shifted in); zero from fend on (a lane past
  // the run's end reads nothing)
  __device__ __forceinline__ void load(long long f, long long fend, bool history) {
    if (history) {
#pragma unroll
      for (int j = 0; j < H; ++j)
#pragma unroll
        for (int i = 0; i < P; ++i)
          w[j][i] = f - H + j < fend ? sample(f - H + j, p[i]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < P; ++i)
        w[H + q][i] = f + q < fend ? sample(f + q, p[i]) : make_float2(0.f, 0.f);
  }

  // u of frame f + q, column i; q and i are constants once the caller unrolls
  __device__ __forceinline__ float2 out(int q, int i) const {
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      if (k < K) {
        const float2 x = w[H + q - k][i];
        ar = fmaf(h[k][i], x.x, ar);
        ai = fmaf(h[k][i], x.y, ai);
      }
    }
    return make_float2(ar, ai);
  }

  // the next step's history: the last H frames of this one
  __device__ __forceinline__ void shift() {
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < P; ++i) w[j][i] = w[j + Q][i];
  }

  // The history kept in shared memory instead (the cluster kernels, whose
  // FFT needs the registers): ring[j * stride + i * npt] holds frame f - H + j
  // of column i, ring pointing at this thread's first column.
  __device__ __forceinline__ void restore(const float2* ring, int stride, int npt) {
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < P; ++i) w[j][i] = ring[j * stride + i * npt];
  }
  __device__ __forceinline__ void save(float2* ring, int stride, int npt) const {
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < P; ++i) ring[j * stride + i * npt] = w[j + Q][i];
  }
};

// The polyphase frame f for this thread's FFT points, from device memory
// frame by frame (K5's phase one, where the cluster walk measured slower:
// PERF.md): v[m] = u[t + T m], the sums in PfbColumns' order. Tap by tap, so
// that a thread has its 16 points' loads in flight at once; L2 serves the
// K-fold re-read of each sample.
__device__ __forceinline__ void pfb_frame(float2 (&v)[kFftP], const float* __restrict__ xr,
                                          const float* __restrict__ xi, long long xs,
                                          const float2* __restrict__ tail,
                                          const float* __restrict__ h, int M, int K, long long f,
                                          int t) {
  const int T = fft_threads(M);
#pragma unroll
  for (int m = 0; m < kFftP; ++m) v[m] = make_float2(0.f, 0.f);
  for (int k = 0; k < K; ++k) {
    const long long g = f - k;
    float2 x[kFftP];
    float w[kFftP];
#pragma unroll
    for (int m = 0; m < kFftP; ++m) {
      const int p = t + T * m;
      if (m >= M) {
        x[m] = make_float2(0.f, 0.f);
        w[m] = 0.f;
      } else if (g >= 0) {
        const long long n = (g * M + p) * xs;
        x[m] = make_float2(xr[n], xi[n]);
        w[m] = h[k * M + p];
      } else {
        x[m] = tail[(K - 1 + g) * M + p];
        w[m] = h[k * M + p];
      }
    }
#pragma unroll
    for (int m = 0; m < kFftP; ++m)
      v[m] = make_float2(fmaf(w[m], x[m].x, v[m].x), fmaf(w[m], x[m].y, v[m].y));
  }
}

// --- a cluster step: the polyphase columns cross to the CTA of each frame's FFT --------------
//
// K3 and K5 launch clusters of C CTAs (kernels/pfb_plan.py). A cluster walks
// a run of frames in steps of C G frames (G frame groups of M/16 threads a
// CTA): CTA r computes the polyphase of its M/C columns of all the step's
// frames (PfbColumns), and stores frame j's columns into the FFT exchange
// buffer of group j mod G of CTA j div G through distributed shared memory;
// after a cluster barrier every CTA holds its G whole frames and runs rf::fft
// on them from shared memory. So the input crosses device memory once and the
// frame's M points cross the cluster once (8 B a point). Between steps a
// thread's history waits in shared memory (H frames of its columns) and its
// taps are read again through L1, so that only the FFT's registers are live
// across it and two CTAs share an SM. The buffers are reused by the next step
// only after a second cluster barrier (after every CTA's FFT has read them).

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// the address of *p in the shared memory of CTA `rank` of this cluster
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// This thread's place in the cluster's polyphase: CTA `rank` of C owns the
// columns [rank M/C, (rank + 1) M/C); npt threads walk P columns each
// (column p0 + i npt), J lanes of them split the step's C G frames, Q each.
struct ClusterStep {
  int rank, C, lane, J, step, p0, npt;
  __device__ __forceinline__ ClusterStep(int M, int G) {
    rank = static_cast<int>(cluster_rank());
    C = static_cast<int>(cluster_size());
    const int slice = M / C;
    npt = slice / kPfbPoints;
    lane = threadIdx.x / npt;
    J = blockDim.x / npt;
    step = C * G;
    p0 = rank * slice + static_cast<int>(threadIdx.x) % npt;
  }
};

// The step at frame f0 of a run [fa, fb): this thread's columns of its
// lane's Q frames, their polyphase stored into the exchange buffer of the
// CTA that transforms each (frame j = lane Q + q of the step: buffer j mod G
// of CTA j div G, point p at fft_smem(p), rf::fft's layout). ring: this
// CTA's history, H rows of its M/C columns; a lane that walks the whole step
// (J = 1) carries its history there from the run's first step on, the
// others reload theirs. Every CTA of the cluster must have finished reading
// its exchange buffers (the previous step's FFT) before the stores: before
// the call, or (wait) by the cluster barrier whose arrive the caller made,
// waited on here after the loads are issued.
template <int KW>
__device__ __forceinline__ void pfb_step(const float* __restrict__ xr,
                                         const float* __restrict__ xi, long long xs,
                                         const float2* __restrict__ tail,
                                         const float* __restrict__ h, const ClusterStep& cs,
                                         float2* ex, float2* ring, int G, int M, int K,
                                         long long f0, long long fa, long long fb, bool wait) {
  PfbColumns<KW> pc(xr, xi, xs, tail, h, M, K, cs.p0, cs.npt);
  const bool reload = f0 == fa || cs.J > 1;
  pc.load(f0 + cs.lane * kPfbFrames, fb, reload);
  float2* mine = ring + static_cast<int>(threadIdx.x) % cs.npt;
  const int stride = cs.npt * kPfbPoints;
  if (!reload) pc.restore(mine, stride, cs.npt);
  if (wait) cluster_wait();  // the caller's arrive after its previous FFT
#pragma unroll
  for (int q = 0; q < kPfbFrames; ++q) {
    const int j = cs.lane * kPfbFrames + q;
    const int dst = j / G;
    float2* d = cluster_map(ex + (j - dst * G) * fft_exchange_points(M), dst);
#pragma unroll
    for (int i = 0; i < kPfbPoints; ++i) d[fft_smem(pc.p[i])] = pc.out(q, i);
  }
  if (cs.J == 1) pc.save(mine, stride, cs.npt);
}

// This group's frame from its exchange buffer, in rf::fft's input layout:
// v[m] = u[t + T m].
__device__ __forceinline__ void exchange_frame(float2 (&v)[kFftP], const float2* ex, int M,
                                               int t) {
  const int T = fft_threads(M);
#pragma unroll
  for (int m = 0; m < kFftP; ++m) v[m] = m < M ? ex[fft_smem(t + T * m)] : make_float2(0.f, 0.f);
}

// The query behind kernels/pfb_plan.py: registers, resident blocks per SM
// and clusters on the current device for `kernel` at (threads, smem,
// cluster C; C = 0: no cluster), SMs, local memory. out: regs, blocks per
// SM, clusters, C, threads, smem, local bytes, SMs.
template <typename... Params>
__host__ cudaError_t occupancy(void (*kernel)(Params...), int threads, size_t smem, int C,
                               int* out) {
  int dev = 0, sms = 0, per_sm = 0, clusters = 0;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess && C > 0) {
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<void*>(kernel), &cfg);
  }
  if (e != cudaSuccess) return e;
  const int vals[8] = {fa.numRegs, per_sm, clusters, C, threads, static_cast<int>(smem),
                       static_cast<int>(fa.localSizeBytes), sms};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return cudaSuccess;
}

// Launch `kernel` on clusters of C CTAs. A launch the card refuses returns
// its error; there is no launch without the cluster.
template <typename... Params, typename... Args>
__host__ cudaError_t launch_cluster(void (*kernel)(Params...), int grid, int threads, size_t smem,
                                    int C, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many blocks of `kernel` stay resident on the current device at
// (threads, smem), with its dynamic shared memory raised to smem; cached per
// kernel for the last (device, threads, smem), so that a launch does not
// repeat the queries.
template <auto kernel>
__host__ cudaError_t resident_blocks(int threads, size_t smem, int* blocks) {
  static int c_dev = -1, c_threads = 0, c_blocks = 0;
  static size_t c_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != c_dev || threads != c_threads || smem != c_smem) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    c_dev = dev;
    c_threads = threads;
    c_smem = smem;
    c_blocks = sms * per_sm;
  }
  *blocks = c_blocks;
  return cudaSuccess;
}

// Per-channel constants and the 7-row carry of the demod/AGC back end.
// Carry rows: 0 am x_prev, 1 am y_prev, 2 nfm re, 3 nfm im, 4 release env,
// 5 attack lpf, 6 power sum.
// The walk's counters after a kernel's own barriers: one grid barrier per
// pass before the last, then the attack flag (kernels/walk_plan.py
// WALK_COUNTERS).
constexpr int kWalkBarriers = 3;
constexpr int kWalkCounters = kWalkBarriers + 1;

struct DemodArgs {
  const int* mode;
  const int* cw_word;
  const int* cw_acc;
  const float* rel;
  const float* al;
  const float* tgt;
  const float* mg;
  const float* st_in;  // (7, M)
  float* audio;        // (F, M) frame-major; (M, F) channel-major under the walk's
                       // kChannelMajor, the layout the caller's next op reads (K5's
                       // single-pass chain returns (M, F): no transposed copy after it)
  float* wf;           // (F / wf_avg, M); unused when wf_avg = 0
  float* st_out;       // (7, M); (8, M) under the walk's kLastGain
  float* v;            // (F, M) scratch: the demod value before AM and AGC
  float* p;            // (F, M) scratch: |X|^2
  unsigned int* barrier;
  float* env;          // (F, M) release env under kAgcEmitEnv, else null
  int M, F, en, wf_avg;  // wf_avg = 0: no power sum, no waterfall
  int agc;               // an Agc
  float dev_scale;  // fs_channel / (2 pi deviation)
  float cw_scale;   // 2 pi / 2^32
  int S;            // time segments of the walk (walk_plan.py); 1: the sequential walk
  float* seg;       // (4, S, M) segment summaries: AM y, release env, attack lpf, power;
                    // null when S = 1
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

// --- the per-channel walk, segmented in time ------------------------------------------------
//
// Per channel, in frame order: the AM DC block (for every channel when AM is
// enabled, as the carry demands), the AGC release max-decay
// env = max(|a|, rel*env), the attack one-pole lpf = al*lpf + (1-al)*env
// (lpf = env where al = 0), the gain clip with the NFM bypass, the power sum
// and the frame-averaged waterfall power (these two off when wf_avg = 0,
// carry row 6 then passed through). Under kAgcEmitEnv the release alone runs
// from carry row 4 and each frame's env is stored: no attack, no gain, row 5
// passed through. Under kAgcOff rows 4 and 5 pass through.
//
// One thread per channel walking all F frames leaves the card idle (4096
// channels are 128 warps; K6's 128 channels four) and is paced by a chain of
// F dependent steps. So each channel's frames are cut into S segments of L
// frames (L a multiple of wf_avg, the last segment possibly shorter), and
// work items are (channel, segment) pairs, channel fastest, so that a warp's
// loads of one frame are one line. Every recurrence composes across segments
// through a per-(segment, channel) summary, a walk of the segment from zero:
//   AM x_prev  the carry into segment s is sqrt(p[sL - 1]), read directly;
//   AM y       affine: y_in(s+1) = pole^L y_in(s) + y_loc(s);
//   release    max-times: env_in(s+1) = max(env_loc(s), rel^L env_in(s)),
//              rel*max(a, b) = max(rel*a, rel*b) holding in floats too;
//   attack     affine once env is exact: lpf_in(s+1) = al^L lpf_in(s) + lpf_loc(s);
//   power      a sum: row 6 = sum over s of partial(s), partial(0) from row 6.
// The passes, each ended by a grid barrier:
//   summary  (S > 1 with AM enabled, or with power and no release pass) the AM
//            DC block from y = 0 -> y_loc; the power partials;
//   release  (S > 1, kAgcApply or kAgcEmitEnv) exact y_in, the release from
//            env = 0 -> env_loc; the power partials if the summary pass did not
//            run; sets the attack flag where a channel has al != 0;
//   attack   (S > 1, kAgcApply, the flag set; items with al != 0) exact y_in
//            and env_in, the attack from lpf = 0 -> lpf_loc;
//   final    every item from its exact carries: audio, env (kAgcEmitEnv),
//            waterfall lines; the last segment's item writes the carry.
// An item composes the summaries of the segments before it itself (at most
// S - 1 reads each), so the carries need no pass of their own. rel^L, al^L
// and pole^L are powf in float on the device, once per item; rel^L may
// underflow to 0, which is exact enough (env_loc then dominates). With S = 1
// only the final pass runs, from the carry rows: the sequential walk, the same
// operations in the same order. Reads the phase-one scratch and the summaries
// with __ldcg: other blocks wrote them.
//
// Channel-major audio (kChannelMajor, K5's single-pass chain): a warp's items
// are 32 consecutive channels of one segment when M is a multiple of 32, so
// the final pass writes each frame's 32 values into the warp's tile in shared
// memory (32 channels x 32 frames, rows padded to 33 words against bank
// conflicts) and, every 32 frames and at the segment's end, stores the tile
// as 32 channel rows of up to 32 consecutive frames: a 128 B line a store,
// as many stores as the frame-major walk makes. Smaller M stores each value
// directly at its channel-major address.

enum WalkPass : int { kPassSummary = 0, kPassRelease = 1, kPassAttack = 2, kPassFinal = 3 };

// Frames per segment: whole waterfall lines, ceil(lines / S) of them.
__host__ __device__ constexpr int walk_length(int F, int S, int wf_avg) {
  return (wf_avg > 0 ? wf_avg : 1) * ((F / (wf_avg > 0 ? wf_avg : 1) + S - 1) / S);
}

// Whether (F, S, wf_avg) is a segmentation the walk takes: F whole lines,
// 1 <= S <= lines, and exactly S segments of walk_length frames.
__host__ __device__ constexpr bool walk_plan_ok(int F, int S, int wf_avg) {
  return F > 0 && S >= 1 && F % (wf_avg > 0 ? wf_avg : 1) == 0 &&
         S <= F / (wf_avg > 0 ? wf_avg : 1) &&
         (F + walk_length(F, S, wf_avg) - 1) / walk_length(F, S, wf_avg) == S;
}

// x through the affine summaries of segments 0..s-1 (L frames each, pole a):
// x <- a^L x + b(k)
__device__ __forceinline__ float compose_affine(float x, float a, int L, const float* sum, int s,
                                                int M, int c) {
  if (s == 0) return x;
  const float aL = powf(a, static_cast<float>(L));
#pragma unroll 8
  for (int k = 0; k < s; ++k) x = aL * x + __ldcg(sum + static_cast<long long>(k) * M + c);
  return x;
}

// x through the max-decay summaries of segments 0..s-1: x <- max(b(k), r^L x)
__device__ __forceinline__ float compose_maxdecay(float x, float r, int L, const float* sum,
                                                  int s, int M, int c) {
  if (s == 0) return x;
  const float rL = powf(r, static_cast<float>(L));
#pragma unroll 8
  for (int k = 0; k < s; ++k) x = fmaxf(__ldcg(sum + static_cast<long long>(k) * M + c), rL * x);
  return x;
}

// Frames in a warp's channel-major tile, and the tile's row pitch in words.
constexpr int kTileFrames = 32;
constexpr int kTilePitch = kTileFrames + 1;

// Shared bytes of the channel-major tiles of a block of `threads` threads.
__host__ __device__ constexpr size_t walk_tile_bytes(int threads) {
  return sizeof(float) * static_cast<size_t>(threads / 32) * 32 * kTilePitch;
}

// A warp's tile out to channel-major audio: channels c0..c0+31, n <= 32
// frames from frame f, each store one channel's n consecutive frames.
__device__ __forceinline__ void store_tile(const DemodArgs& a, const float* tile, int c0, int f,
                                           int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < n) {
    float* dst = a.audio + static_cast<long long>(c0) * a.F + f + lane;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) dst[static_cast<long long>(r) * a.F] = tile[r * kTilePitch + lane];
  }
  __syncwarp();
}

// One pass of one item (channel c, segment s). power: this pass sums the
// segment's power partial into the summaries (summary or release pass).
// kChannelMajor: the final pass writes (M, F) audio, through `tile` (the
// warp's, when M is a multiple of 32) or directly (tile null). kLastGain
// (under kAgcApply): the last item also writes the last frame's gain,
// min(mg, tgt / max(lpf, 1e-9)), as carry row 7 (K6 in the chain's form).
template <int pass, bool kChannelMajor = false, bool kLastGain = false>
__device__ __forceinline__ void agc_walk(const DemodArgs& a, int c, int s, bool power,
                                         float* tile = nullptr) {
  const int M = a.M, S = a.S;
  const int L = walk_length(a.F, S, a.wf_avg);
  const int fa = s * L;
  const int fb = fa + L > a.F ? a.F : fa + L;
  const bool last = s == S - 1;
  const float* st = a.st_in;
  const int mode = a.mode[c];
  const bool en_am = enabled(a.en, kAM);
  const bool is_am = en_am && mode == kAM;
  const bool bypass = mode == kNFM;
  const bool aux = a.wf_avg > 0;
  const bool apply = a.agc == kAgcApply, emit = a.agc == kAgcEmitEnv;
  const bool fin = pass == kPassFinal;
  const float rel = a.rel[c], al = a.al[c], tgt = a.tgt[c], mg = a.mg[c];
  const long long SM = static_cast<long long>(S) * M;
  float* sum_y = a.seg;
  float* sum_env = a.seg + SM;
  float* sum_lpf = a.seg + 2 * SM;
  float* sum_pw = a.seg + 3 * SM;
  // what this pass walks (the final pass: the sequential walk's own steps)
  const bool dc = pass == kPassSummary ? en_am : fin ? en_am && (is_am || last) : is_am;
  const bool release = pass == kPassRelease || pass == kPassAttack || (fin && (apply || emit));
  const bool attack = pass == kPassAttack || (fin && apply);
  const bool sum_power = aux && power;
  // the carries into the segment: zero where this pass forms a summary
  float am_x = 0.f, am_y = 0.f, env = 0.f, lpf = 0.f;
  if (dc) {
    am_x = s == 0 ? st[c] : sqrtf(__ldcg(a.p + static_cast<long long>(fa - 1) * M + c));
    if (pass != kPassSummary) am_y = compose_affine(st[M + c], kDcPole, L, sum_y, s, M, c);
  }
  if (release && pass != kPassRelease)
    env = compose_maxdecay(st[4 * M + c], rel, L, sum_env, s, M, c);
  if (attack && pass != kPassAttack)  // al = 0: lpf = env from the first frame on
    lpf = al == 0.f ? st[5 * M + c] : compose_affine(st[5 * M + c], al, L, sum_lpf, s, M, c);
  float pw = s == 0 ? st[6 * M + c] : 0.f;  // the power partial (row 6 when S = 1)
  const bool need_v = fin || (release && !is_am);
  const bool need_p = fin || dc || sum_power;
  const float avg = static_cast<float>(a.wf_avg);
  float wacc = 0.f;  // the current waterfall line's power sum, over nacc frames
  int nacc = 0;
  long long line = aux ? fa / a.wf_avg : 0;
  // frames loaded per batch (16 cost K5's kernel 0.2 ms on an H100:
  // probe_channelizer.py's "walk batch" variants)
  constexpr int U = 8;
  for (int f0 = fa; f0 < fb; f0 += U) {
    float pv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = static_cast<long long>(f0 + u) * M + c;
      pv[u] = need_p && f0 + u < fb ? __ldcg(a.p + i) : 0.f;
      vv[u] = need_v && f0 + u < fb ? __ldcg(a.v + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + u;
      if (f >= fb) break;
      float out = vv[u];
      if (dc) {
        const float e = sqrtf(pv[u]);
        const float y = (e - am_x) + kDcPole * am_y;
        am_x = e;
        am_y = y;
        if (is_am) out = y;
      }
      if (!fin) {  // a summary
        if (release) env = fmaxf(fabsf(out), rel * env);
        if (attack) lpf = al == 0.f ? env : al * lpf + (1.f - al) * env;
        if (sum_power) pw += pv[u];
        continue;
      }
      if (apply) {
        env = fmaxf(fabsf(out), rel * env);
        lpf = al == 0.f ? env : al * lpf + (1.f - al) * env;
        const float gain = fminf(mg, tgt / fmaxf(lpf, 1e-9f));
        if (!bypass) out *= gain;
      } else if (emit) {
        env = fmaxf(fabsf(out), rel * env);
        a.env[static_cast<long long>(f) * M + c] = env;
      }
      if constexpr (kChannelMajor) {
        if (tile != nullptr)
          tile[(c & 31) * kTilePitch + ((f - fa) & (kTileFrames - 1))] = out;
        else
          a.audio[static_cast<long long>(c) * a.F + f] = out;
      } else {
        a.audio[static_cast<long long>(f) * M + c] = out;
      }
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
    if constexpr (kChannelMajor) {  // a full tile, or the segment's last frames
      const int done = (f0 + U < fb ? f0 + U : fb) - fa;
      if (tile != nullptr && (done % kTileFrames == 0 || f0 + U >= fb)) {
        const int t0 = (done - 1) / kTileFrames * kTileFrames;
        store_tile(a, tile, c & ~31, fa + t0, done - t0);
      }
    }
  }
  const long long i = static_cast<long long>(s) * M + c;
  if (pass == kPassSummary && en_am) sum_y[i] = am_y;
  if (pass == kPassRelease) sum_env[i] = env;
  if (pass == kPassAttack) sum_lpf[i] = lpf;
  if (power && aux) sum_pw[i] = pw;
  if (!fin || !last) return;
  if (aux && S > 1) {  // row 6: the partials in segment order
    pw = __ldcg(sum_pw + c);
    for (int k = 1; k < S; ++k) pw += __ldcg(sum_pw + static_cast<long long>(k) * M + c);
  }
  float* so = a.st_out;
  so[c] = en_am ? am_x : st[c];
  so[M + c] = en_am ? am_y : st[M + c];
  if (!enabled(a.en, kNFM)) {  // else written by phase one from the last frame
    so[2 * M + c] = st[2 * M + c];
    so[3 * M + c] = st[3 * M + c];
  }
  so[4 * M + c] = apply || emit ? env : st[4 * M + c];
  so[5 * M + c] = apply ? lpf : st[5 * M + c];
  so[6 * M + c] = aux ? pw : st[6 * M + c];
  if constexpr (kLastGain) so[7 * M + c] = fminf(mg, tgt / fmaxf(lpf, 1e-9f));
}

// The walk over the whole grid, after a kernel's phase one and its barrier:
// items (c, s) = (i mod M, i div M), thread g taking i = g, g + threads, ...
// with g = (warp * gridDim + block) * 32 + lane, so that with fewer items
// than threads one warp per block is busy before the next warp of any block.
// counters: kWalkCounters zeroed words (the passes' barriers, the attack
// flag). Every block runs the same passes: the conditions are uniform.
// kChannelMajor: the audio is (M, F); tiles: the block's shared memory, at
// least walk_tile_bytes(blockDim.x), free once phase one is done. kLastGain:
// st_out has an eighth row, the last gain (agc_walk).
template <bool kChannelMajor = false, bool kLastGain = false>
__device__ void agc_walk_all(const DemodArgs& a, unsigned int* counters, float* tiles = nullptr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(warp * gridDim.x + blockIdx.x) * 32 + lane;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long items = static_cast<long long>(a.M) * a.S;
  const bool aux = a.wf_avg > 0;
  const bool apply = a.agc == kAgcApply;
  const bool release = a.S > 1 && (apply || a.agc == kAgcEmitEnv);
  const bool summary = a.S > 1 && (enabled(a.en, kAM) || (aux && !release));
  unsigned int* flag = release ? counters + kWalkBarriers : nullptr;
  int barrier = 0;
  if (summary) {
    for (long long i = first; i < items; i += stride)
      agc_walk<kPassSummary>(a, static_cast<int>(i % a.M), static_cast<int>(i / a.M), true);
    grid_barrier(counters + barrier++);
  }
  if (release) {
    for (long long i = first; i < items; i += stride) {
      const int c = static_cast<int>(i % a.M);
      agc_walk<kPassRelease>(a, c, static_cast<int>(i / a.M), !summary);
      // one store per warp that has a channel with a nonzero attack
      const unsigned int active = __activemask();
      if (__ballot_sync(active, apply && a.al[c] != 0.f) && lane == __ffs(active) - 1)
        *reinterpret_cast<volatile unsigned int*>(flag) = 1u;
    }
    grid_barrier(counters + barrier++);
  }
  if (release && apply && __ldcg(flag) != 0u) {
    for (long long i = first; i < items; i += stride) {
      const int c = static_cast<int>(i % a.M);
      if (a.al[c] != 0.f) agc_walk<kPassAttack>(a, c, static_cast<int>(i / a.M), false);
    }
    grid_barrier(counters + barrier++);
  }
  float* tile = nullptr;  // a warp's items share one segment when M % 32 == 0
  if constexpr (kChannelMajor)
    if (a.M % 32 == 0) tile = tiles + warp * 32 * kTilePitch;
  for (long long i = first; i < items; i += stride)
    agc_walk<kPassFinal, kChannelMajor, kLastGain>(a, static_cast<int>(i % a.M),
                                                   static_cast<int>(i / a.M), false, tile);
}

}  // namespace rf
