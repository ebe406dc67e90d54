// K-tap type-1 polyphase accumulation over M-sample frames + M-point DFT,
// for Hopper: the channelizer's PFB front half (K3), and K3's stage
// variants (K9) as the kernel's template argument.
//
// Replaces the Pallas TPU kernel radioframe/kernels/pfb_dft.py::_kernel
// (driven by FusedPfbDft.call_planes). Same function, rethought for a GPU:
//
//   * The TPU kernel carries K-1 frames of history in VMEM scratch across a
//     sequential grid. Here a cluster of 8 CTAs walks a run of frames in
//     time order (kernels/pfb_plan.py plans the runs): each CTA walks its
//     M/8 columns with the history and the taps in registers
//     (rf::PfbColumns, channelizer.cuh), so each input sample is read from
//     device memory once per run (the run's first K-1 frames twice) and each
//     tap once per launch; it stores each frame's columns into the shared
//     memory of the CTA that transforms that frame (distributed shared
//     memory, rf::pfb_scatter). Shared memory could not hold the history
//     instead (K frames of 4096 points are 256 KB), nor registers at one
//     frame's 16 points a thread (224 registers).
//   * The DFT is rf::fft (channelizer.cuh), the register-resident
//     mixed-radix Stockham FFT, FP32 with a float64-built twiddle table
//     staged in shared memory, not the TPU's Cooley-Tukey matrix products on
//     the MXU (and so no bf16x3 split). Its input is the frame the cluster
//     delivered to the exchange buffer it starts from.
//   * Output is (F, M) re/im planes in channel order, written coalesced.
//   * Bound: device-memory bytes. Each input sample is read once (8 B) and
//     each output written once (8 B): 134 MB at M = 4096, F = 2048, ~40 us
//     at 3.35 TB/s, against ~0.6 GFLOP of FFT and polyphase arithmetic.
//     Measured by chip_smoke.py on an H100 SXM at 700 W (PERF.md): 0.12 ms
//     (33% of the bound) against 0.16 for the stage this replaced, which
//     re-read K = 8 frames and the taps through L2 for every frame; 29 runs
//     of 72 frames read the input 1.10 times. What is left: the FFT (0.053
//     ms alone), two cluster barriers a step, and the spills of the FFT's
//     126 registers under the 128 of two CTAs an SM.
//
// K9 replaces the Pallas TPU kernel tools/probe_pfbdft_stages.py::_kern, the
// cost decomposition of K3. Its variants, each with a plain version in
// kernels/pfb_dft.py:
//   base_b3     K3 itself (the same code path, so the same bits);
//   pfb_only    the polyphase accumulation alone, sample order: the column
//               walk of rf::PfbColumns with no cluster, straight to device
//               memory (blocks of 256 threads = 512 columns, a run of frames
//               each): 0.06 ms against the stage before's 0.11;
//   pfb_noshift the probe's timing-only arithmetic: every tap reads the
//               current frame (no shifted history); one block a frame, as
//               before (the column walk measured slower for it);
//   dft_only    the DFT of the raw frame (rf::fft), no polyphase;
//   batched_b3  the polyphase, then the DFT as the probe's explicit
//               Cooley-Tukey product on the tensor cores: M = M1 M2 with
//               M2 = 128, stage one W1^T (M1 x M1) times each frame's
//               (M1 x 128) view, the twiddle (FP32 complex products), stage
//               two the (frames M1 x 128) rows times W2 (128 x 128); both
//               products mma.sync m16n8k8 TF32 written here, complex as four
//               real products, each real product split 3xTF32 (hi = the
//               round-to-nearest TF32 of x, lo = TF32 of the rest; lo hi +
//               hi lo + hi hi in FP32), so that the result keeps FP32's
//               2e-4-of-scale agreement. A block takes 64 / M1 frames at a
//               time, whose planes sit in shared memory (in place: stage
//               one's output overwrites its input); W1, TW and W2 are read
//               from the L1/L2-resident table. Bound: operations, 11 GFLOP at
//               M = 4096, F = 2048 (0.165 ms at FP32's 67 TFLOP/s; as 3xTF32,
//               32 GFLOP of tensor-core work and the polyphase at FP32,
//               0.070 ms at 495 TFLOP/s). Measured: 0.42 ms against the
//               FP32 form's 0.77; its polyphase re-reads K - 1 + NF frames
//               for NF through L2, and 128 registers spill.

#include "channelizer.cuh"

namespace {

enum Variant : int { kBase = 0, kPfbOnly = 1, kPfbNoshift = 2, kDftOnly = 3, kBatched = 4 };

constexpr int kColumnThreads = 256;  // pfb_only / pfb_noshift: 512 columns a block

// --- base_b3 (K3): the cluster walk and rf::fft -------------------------------------------

// Clusters of C CTAs, one run of run_length frames each (the last cut at F);
// CTA rank r of cluster c transforms frames c L + s C G + r G + g.
template <int KW, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads > 256 ? 1 : 2)
pfb_cluster_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
                   const float2* __restrict__ tail, const float* __restrict__ h,
                   const float2* __restrict__ tw, float* __restrict__ yr, float* __restrict__ yi,
                   int M, int K, int F, int run_length) {
  extern __shared__ float2 buf[];
  const int T = rf::fft_threads(M);
  const int G = blockDim.x / T;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  float2* tws = buf;
  float2* ex = buf + rf::fft_twiddle_points(M);
  float2* exg = ex + g * rf::fft_exchange_points(M);
  float2* ring = ex + G * rf::fft_exchange_points(M);  // KW - 1 rows of this CTA's M/C columns
  rf::stage_twiddles(tws, tw, M);
  const rf::ClusterStep cs(M, G);
  const long long fa = static_cast<long long>(blockIdx.x / cs.C) * run_length;
  const long long fb = fa + run_length < F ? fa + run_length : F;
  rf::cluster_arrive();  // every CTA of the cluster runs before the first remote store
  for (long long f0 = fa; f0 < fb; f0 += cs.step) {
    rf::pfb_step<KW>(xr, xi, xs, tail, h, cs, ex, ring, G, M, K, f0, fa, fb, true);
    rf::cluster_sync();  // every frame of the step is whole
    float2 v[rf::kFftP];
    rf::exchange_frame(v, exg, M, t);
    rf::fft(v, exg, tws, M, t);
    rf::cluster_arrive();  // this CTA's buffers are free for the next step
    const long long f = f0 + cs.rank * G + g;
    if (f < fb) {
#pragma unroll
      for (int m = 0; m < rf::kFftP; ++m) {
        yr[f * M + t + T * m] = v[m].x;
        yi[f * M + t + T * m] = v[m].y;
      }
    }
  }
  rf::cluster_wait();
}

// --- pfb_only: the column walk alone ----------------------------------------------------

// Blocks of kColumnThreads (or M/2) threads, each P columns; block b takes
// columns of block b mod (M / (P threads)) over run b div that.
template <int KW>
__global__ void __launch_bounds__(kColumnThreads, 2)
pfb_columns_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
                   const float2* __restrict__ tail, const float* __restrict__ h,
                   float* __restrict__ yr, float* __restrict__ yi, int M, int K, int F,
                   int run_length) {
  const int per_block = blockDim.x * rf::kPfbPoints;
  const int blocks = M / per_block;
  const int pb = blockIdx.x % blocks;
  rf::PfbColumns<KW> pc(xr, xi, xs, tail, h, M, K, pb * per_block + threadIdx.x, blockDim.x);
  const long long fa = static_cast<long long>(blockIdx.x / blocks) * run_length;
  const long long fb = fa + run_length < F ? fa + run_length : F;
  for (long long f0 = fa; f0 < fb; f0 += rf::kPfbFrames) {
    pc.load(f0, fb, f0 == fa);
#pragma unroll
    for (int q = 0; q < rf::kPfbFrames; ++q) {
      if (f0 + q >= fb) break;
#pragma unroll
      for (int i = 0; i < rf::kPfbPoints; ++i) {
        const float2 u = pc.out(q, i);
        yr[(f0 + q) * M + pc.p[i]] = u.x;
        yi[(f0 + q) * M + pc.p[i]] = u.y;
      }
    }
    pc.shift();
  }
}

// --- pfb_noshift: one block a frame ------------------------------------------------------

// Every tap on the current frame, summed in tap order with fmaf; a sample's
// K reads after the first hit L1, so the input crosses device memory once.
// (The column walk measured slower for this variant: PERF.md.)
__global__ void __launch_bounds__(512)
pfb_noshift_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
                   const float* __restrict__ h, float* __restrict__ yr, float* __restrict__ yi,
                   int M, int K) {
  const long long f = blockIdx.x;
  for (int p = threadIdx.x; p < M; p += blockDim.x) {
    const long long n = (f * M + p) * xs;
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = h[k * M + p];
      ar = fmaf(w, xr[n], ar);
      ai = fmaf(w, xi[n], ai);
    }
    yr[f * M + p] = ar;
    yi[f * M + p] = ai;
  }
}

// --- dft_only: rf::fft of the raw frames ---------------------------------------------------

// Persistent blocks of G = blockDim / (M/16) frames at a time.
__global__ void __launch_bounds__(512)
dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
           const float2* __restrict__ tw, float* __restrict__ yr, float* __restrict__ yi, int M,
           int F) {
  extern __shared__ float2 buf[];
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
}

// --- batched_b3: the Cooley-Tukey product on the tensor cores ------------------------------

constexpr int kCtM2 = 128;   // M2, the reference's split
constexpr int kCtRs = 136;   // plane row stride in floats: stage one's B loads hit 32 banks
constexpr int kCtRows = 64;  // stage-two rows a block step: NF frames of M1 rows
constexpr int kCtThreads = 256;
constexpr int kCtWin = 16 - 1 + 4;  // the polyphase window: 16 taps at most, NF <= 4 frames

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value (round to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 TF32 tile: a (16 x 8, row) a[0] (g, t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4); b (8 x 8, col) b[0] (t, g), b[1] (t + 4, g);
// c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t), c[3] (g + 8, 2t + 1);
// g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A complex A fragment (re, im) split hi/lo, and a complex B fragment with
// -im too (for -Ai Bi).
struct FragA {
  uint32_t rh[4], rl[4], ih[4], il[4];
};
struct FragB {
  uint32_t rh[2], rl[2], ih[2], il[2], nh[2], nl[2];
};

__device__ __forceinline__ void set_a(FragA& a, int i, float2 x) {
  split(x.x, a.rh[i], a.rl[i]);
  split(x.y, a.ih[i], a.il[i]);
}
__device__ __forceinline__ void set_b(FragB& b, int i, float2 x) {
  split(x.x, b.rh[i], b.rl[i]);
  split(x.y, b.ih[i], b.il[i]);
  b.nh[i] = b.ih[i] ^ 0x80000000u;
  b.nl[i] = b.il[i] ^ 0x80000000u;
}

// c += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// (cr, ci) += A B, complex: Cr += Ar Br - Ai Bi, Ci += Ar Bi + Ai Br
__device__ __forceinline__ void cmma(float (&cr)[4], float (&ci)[4], const FragA& a,
                                     const FragB& b) {
  mma3(cr, a.rh, a.rl, b.rh, b.rl);
  mma3(cr, a.ih, a.il, b.nh, b.nl);
  mma3(ci, a.rh, a.rl, b.ih, b.il);
  mma3(ci, a.ih, a.il, b.rh, b.rl);
}

// ct: W1 (M1 x M1, [n1][k1]), then TW (M2 x M1, [n2][k1] = e^{-2 pi i n2 k1 / M}),
// then W2 (M2 x M2, [n2][k2]), complex64 built in float64 (kernels/pfb_dft.py
// ct_tables). Persistent blocks of 8 warps, NF = 64 / M1 frames a step.
template <int M1>
__global__ void __launch_bounds__(kCtThreads, 2)
pfb_batched_kernel(const float* __restrict__ xr, const float* __restrict__ xi, long long xs,
                   const float2* __restrict__ tail, const float* __restrict__ h,
                   const float2* __restrict__ ct, float* __restrict__ yr,
                   float* __restrict__ yi, int K, int F) {
  constexpr int M = M1 * kCtM2;
  constexpr int NF = kCtRows / M1;
  constexpr int MT1 = M1 / 16, NT1 = 2 * NF;  // stage one's tiles a warp (8 of them)
  constexpr int MT2 = kCtRows / 16, NT2 = 2;  // stage two's
  constexpr int plane = M1 * kCtRs;
  extern __shared__ float sm[];  // [frame][re, im][M1 rows of kCtRs]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2* w1 = ct;
  const float2* twc = ct + M1 * M1;
  const float2* w2 = twc + kCtM2 * M1;
  for (long long f0 = static_cast<long long>(blockIdx.x) * NF; f0 < F;
       f0 += static_cast<long long>(gridDim.x) * NF) {
    // the polyphase of frames f0 .. f0 + NF - 1: xw[j] = x(f0 + NF - 1 - j);
    // two points a pass keep twice the loads in flight (0.33 against 0.42 ms
    // on an H100 SXM at 700 W: PERF.md)
#pragma unroll 2
    for (int p = threadIdx.x; p < M; p += kCtThreads) {
      float2 xw[kCtWin];
#pragma unroll
      for (int j = 0; j < kCtWin; ++j) {
        const long long gf = f0 + NF - 1 - j;
        float2 x = make_float2(0.f, 0.f);
        if (j < NF + K - 1 && gf < F) {
          if (gf >= 0) {
            x = make_float2(__ldg(xr + (gf * M + p) * xs), __ldg(xi + (gf * M + p) * xs));
          } else if (gf >= 1 - K) {
            x = __ldg(tail + (K - 1 + gf) * M + p);
          }
        }
        xw[j] = x;
      }
      float hk[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) hk[k] = k < K ? __ldg(h + k * M + p) : 0.f;
      const int n1 = p / kCtM2, n2 = p - n1 * kCtM2;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < K) {
            const float2 x = xw[NF - 1 - f + k];
            ar = fmaf(hk[k], x.x, ar);
            ai = fmaf(hk[k], x.y, ai);
          }
        }
        sm[(2 * f) * plane + n1 * kCtRs + n2] = ar;
        sm[(2 * f + 1) * plane + n1 * kCtRs + n2] = ai;
      }
    }
    __syncthreads();
    {  // stage one: A[k1][n2] = sum_n1 W1[n1][k1] u[n1][n2], then B = A TW[n2][k1], in place
      constexpr int cols = NT1 * 8;  // a warp's columns, all in one frame
      const int fr = warp * cols / kCtM2;
      const int c0 = warp * cols % kCtM2;
      float* ur = sm + (2 * fr) * plane;
      float* ui = ur + plane;
      float cr[MT1][NT1][4] = {}, ci[MT1][NT1][4] = {};
#pragma unroll
      for (int kk = 0; kk < M1 / 8; ++kk) {
        FragB b[NT1];
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt) {
          const int col = c0 + 8 * nt + g;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int n1 = 8 * kk + t + 4 * i;
            set_b(b[nt], i, make_float2(ur[n1 * kCtRs + col], ui[n1 * kCtRs + col]));
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt) {
          FragA a;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k1 = 16 * mt + g + 8 * (i & 1);
            const int n1 = 8 * kk + t + 4 * (i >> 1);
            set_a(a, i, __ldg(w1 + n1 * M1 + k1));
          }
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) cmma(cr[mt][nt], ci[mt][nt], a, b[nt]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k1 = 16 * mt + g + 8 * (i >> 1);
            const int n2 = c0 + 8 * nt + 2 * t + (i & 1);
            const float2 y = rf::cmul(make_float2(cr[mt][nt][i], ci[mt][nt][i]),
                                      __ldg(twc + n2 * M1 + k1));
            ur[k1 * kCtRs + n2] = y.x;
            ui[k1 * kCtRs + n2] = y.y;
          }
    }
    __syncthreads();
    // stage two: X[f][M1 k2 + k1] = sum_n2 B[f][k1][n2] W2[n2][k2], warp w the
    // columns k2 in [16w, 16w + 16)
    {
      float cr[MT2][NT2][4] = {}, ci[MT2][NT2][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kCtM2 / 8; ++kk) {
        FragB b[NT2];
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            set_b(b[nt], i, __ldg(w2 + (8 * kk + t + 4 * i) * kCtM2 + 16 * warp + 8 * nt + g));
#pragma unroll
        for (int mt = 0; mt < MT2; ++mt) {
          FragA a;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mt + g + 8 * (i & 1);
            const int n2 = 8 * kk + t + 4 * (i >> 1);
            const float* row = sm + (2 * (r / M1)) * plane + (r % M1) * kCtRs + n2;
            set_a(a, i, make_float2(row[0], row[plane]));
          }
#pragma unroll
          for (int nt = 0; nt < NT2; ++nt) cmma(cr[mt][nt], ci[mt][nt], a, b[nt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mt + g + 8 * (i >> 1);
            const int k2 = 16 * warp + 8 * nt + 2 * t + (i & 1);
            const long long f = f0 + r / M1;
            if (f < F) {
              const long long o = f * M + M1 * k2 + r % M1;
              yr[o] = cr[mt][nt][i];
              yi[o] = ci[mt][nt][i];
            }
          }
    }
    __syncthreads();  // the planes are the next step's
  }
}

// --- launches ---------------------------------------------------------------------------

struct Args {
  const float* xr;
  const float* xi;
  long long xs;
  const float2* tail;
  const float* h;
  const float2* tw;
  const float2* ct;
  float* yr;
  float* yi;
  int M, K, F, runs, run_length;
};

int cluster_threads(int M) { return rf::fft_threads(M) < 32 ? 32 : rf::fft_threads(M); }

// the twiddles, G exchange buffers and the history ring (KW - 1 rows of M/C columns)
size_t cluster_smem(int M, int KW) {
  const int G = cluster_threads(M) / rf::fft_threads(M);
  return sizeof(float2) * (rf::fft_twiddle_points(M) +
                           static_cast<size_t>(G) * rf::fft_exchange_points(M) +
                           static_cast<size_t>(KW - 1) * (M / rf::kPfbCluster));
}

int column_threads(int M) {
  return M / rf::kPfbPoints < kColumnThreads ? M / rf::kPfbPoints : kColumnThreads;
}

// batched_b3's planes: NF = 64 / M1 frames of {re, im}, M1 rows of kCtRs floats each
constexpr size_t kCtSmem = sizeof(float) * 2 * kCtRows * kCtRs;

// M and K the card's polyphase stage takes: M a power of two in [16, 8192], 1 <= K <= 16
bool stage_ok(int M, int K) {
  return M >= 16 && M <= 8192 && (M & (M - 1)) == 0 && K >= 1 && K <= 16;
}

template <int KW>
cudaError_t launch_base(const Args& a, cudaStream_t s) {
  const int threads = cluster_threads(a.M);
  const int G = threads / rf::fft_threads(a.M);
  const int step = rf::kPfbCluster * G;
  if (a.run_length < 1 || a.run_length % step || a.runs < 1 ||
      static_cast<long long>(a.runs) * a.run_length < a.F ||
      static_cast<long long>(a.runs - 1) * a.run_length >= a.F)
    return cudaErrorInvalidValue;
  const int grid = a.runs * rf::kPfbCluster;
  const size_t smem = cluster_smem(a.M, KW);
  if (threads > 256)
    return rf::launch_cluster(pfb_cluster_kernel<KW, 512>, grid, threads, smem, rf::kPfbCluster,
                              s, a.xr, a.xi, a.xs, a.tail, a.h, a.tw, a.yr, a.yi, a.M,
                              a.K, a.F, a.run_length);
  return rf::launch_cluster(pfb_cluster_kernel<KW, 256>, grid, threads, smem, rf::kPfbCluster,
                            s, a.xr, a.xi, a.xs, a.tail, a.h, a.tw, a.yr, a.yi, a.M, a.K,
                            a.F, a.run_length);
}

template <int KW>
cudaError_t launch_columns(const Args& a, cudaStream_t s) {
  if (a.run_length < 1 || a.run_length % rf::kPfbFrames || a.runs < 1 ||
      static_cast<long long>(a.runs) * a.run_length < a.F ||
      static_cast<long long>(a.runs - 1) * a.run_length >= a.F)
    return cudaErrorInvalidValue;
  const int threads = column_threads(a.M);
  const int grid = a.runs * (a.M / (threads * rf::kPfbPoints));
  pfb_columns_kernel<KW><<<grid, threads, 0, s>>>(a.xr, a.xi, a.xs, a.tail, a.h, a.yr, a.yi,
                                                  a.M, a.K, a.F, a.run_length);
  return cudaGetLastError();
}

int noshift_threads(int M) { return M / 2 < 32 ? 32 : (M / 2 > 512 ? 512 : M / 2); }

cudaError_t launch_noshift(const Args& a, cudaStream_t s) {
  pfb_noshift_kernel<<<a.F, noshift_threads(a.M), 0, s>>>(a.xr, a.xi, a.xs, a.h, a.yr, a.yi,
                                                          a.M, a.K);
  return cudaGetLastError();
}

cudaError_t launch_dft(const Args& a, cudaStream_t s) {
  const int threads = cluster_threads(a.M);
  const int G = threads / rf::fft_threads(a.M);
  const size_t smem =
      sizeof(float2) *
      (rf::fft_twiddle_points(a.M) + static_cast<size_t>(G) * rf::fft_exchange_points(a.M));
  int resident = 0;
  cudaError_t err = rf::resident_blocks<dft_kernel>(threads, smem, &resident);
  if (err != cudaSuccess) return err;
  const int grid = (a.F + G - 1) / G < resident ? (a.F + G - 1) / G : resident;
  dft_kernel<<<grid, threads, smem, s>>>(a.xr, a.xi, a.xs, a.tw, a.yr, a.yi, a.M, a.F);
  return cudaGetLastError();
}

template <int M1>
cudaError_t launch_batched_m1(const Args& a, cudaStream_t s) {
  const size_t smem = kCtSmem;
  int resident = 0;
  cudaError_t err = rf::resident_blocks<pfb_batched_kernel<M1>>(kCtThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  constexpr int NF = kCtRows / M1;
  const int grid = (a.F + NF - 1) / NF < resident ? (a.F + NF - 1) / NF : resident;
  pfb_batched_kernel<M1><<<grid, kCtThreads, smem, s>>>(a.xr, a.xi, a.xs, a.tail, a.h, a.ct,
                                                       a.yr, a.yi, a.K, a.F);
  return cudaGetLastError();
}

cudaError_t launch_batched(const Args& a, cudaStream_t s) {
  if (a.K < 1 || a.K > 16) return cudaErrorInvalidValue;
  switch (a.M) {
    case 2048: return launch_batched_m1<16>(a, s);
    case 4096: return launch_batched_m1<32>(a, s);
    case 8192: return launch_batched_m1<64>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = launched). variant: the index in
// VARIANTS of kernels/pfb_dft.py (0 = K3); tw is the FFT's twiddle table
// (kernels/fft_plan.py), read by base_b3 and dft_only; ct, M1, M2 are read by
// the batched variant only; runs and run_length are the plan of base_b3
// (clusters) and the pfb variants (runs of blocks) from kernels/pfb_plan.py.
int rf_pfb_dft(const float* xr, const float* xi, long long xs, const void* tail, const float* h,
               const void* tw, const void* ct, float* yr, float* yi, int M, int K, int M1,
               int M2, int F, int variant, int runs, int run_length, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{xr, xi, xs, static_cast<const float2*>(tail), h, static_cast<const float2*>(tw),
               static_cast<const float2*>(ct), yr, yi, M, K, F, runs, run_length};
  if (variant == kBatched && (M1 != M / kCtM2 || M2 != kCtM2))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((variant == kBase || variant == kPfbOnly) && !stage_ok(M, K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (variant) {
    case kBase: err = K <= 8 ? launch_base<8>(a, s) : launch_base<16>(a, s); break;
    case kPfbOnly: err = K <= 8 ? launch_columns<8>(a, s) : launch_columns<16>(a, s); break;
    case kPfbNoshift: err = launch_noshift(a, s); break;
    case kDftOnly: err = launch_dft(a, s); break;
    case kBatched: err = launch_batched(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The launch's resources on the current device (rf::occupancy's eight
// values: registers, blocks per SM, clusters, cluster size, threads, shared
// bytes, local bytes, SMs) for `variant` at (M, K).
int rf_pfb_dft_occupancy(int variant, int M, int K, int* out) {
  const bool ok = stage_ok(M, K);
  const bool big = cluster_threads(M) > 256;
  const int threads = cluster_threads(M);
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kBase && ok) {
    const int C = rf::kPfbCluster;
    if (K <= 8)
      err = big ? rf::occupancy(pfb_cluster_kernel<8, 512>, threads, cluster_smem(M, 8), C, out)
                : rf::occupancy(pfb_cluster_kernel<8, 256>, threads, cluster_smem(M, 8), C, out);
    else
      err = big ? rf::occupancy(pfb_cluster_kernel<16, 512>, threads, cluster_smem(M, 16), C, out)
                : rf::occupancy(pfb_cluster_kernel<16, 256>, threads, cluster_smem(M, 16), C, out);
  } else if (variant == kPfbOnly && ok) {
    err = K <= 8 ? rf::occupancy(pfb_columns_kernel<8>, column_threads(M), 0, 0, out)
                 : rf::occupancy(pfb_columns_kernel<16>, column_threads(M), 0, 0, out);
  } else if (variant == kPfbNoshift) {
    err = rf::occupancy(pfb_noshift_kernel, noshift_threads(M), 0, 0, out);
  } else if (variant == kBatched) {
    const size_t smem = kCtSmem;
    if (M == 2048) err = rf::occupancy(pfb_batched_kernel<16>, kCtThreads, smem, 0, out);
    if (M == 4096) err = rf::occupancy(pfb_batched_kernel<32>, kCtThreads, smem, 0, out);
    if (M == 8192) err = rf::occupancy(pfb_batched_kernel<64>, kCtThreads, smem, 0, out);
  }
  return static_cast<int>(err);
}

}  // extern "C"
