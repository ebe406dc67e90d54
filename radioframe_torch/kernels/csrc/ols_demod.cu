// The flagship's audio-rate back end in one launch, for Hopper: overlap-save
// mode filter with a per-channel frequency response, demod bank
// (SSB/LSB/CW/AM/NFM) and attack/release AGC.
//
// Replaces the Pallas TPU kernel radioframe/kernels/ols_demod.py::_kernel
// (driven by FusedOlsDemod.__call__). Function, per channel c and frame f of
// hop outputs: the window w = [tail | x][c, f hop : f hop + nfft],
// Y = IFFT(FFT(w) h_sel[c]), keep Y[L1:], L1 = nfft - hop; then the demod
// bank and the AGC walk over all Ta samples in time order, with the 7-row
// carry (row 6, the power sum, passed through: the flagship takes its power
// from the front end).
//
// The TPU kernel walked frame tiles on a sequential grid, left-multiplying
// Cooley-Tukey factor matrices on its matrix unit and turning every
// recurrence into triangular matrix products. Rethought for a GPU, as one
// cooperative launch in three phases split by grid barriers:
//
//   1. one work item per (channel, frame), nfft/16 threads each (a block
//      holds several): the window straight into registers, rf::fft (the
//      register-resident Stockham FFT of channelizer.cuh), the product with
//      the selected response, conjugated so that a second forward FFT gives
//      the inverse (IFFT(Y) = conj(FFT(conj(Y))) / nfft) on the registers
//      the first one ended in, and the hop kept samples written to two
//      (Ta, C) time-major scratch planes;
//   2. over the whole grid, |s|^2 and the demod value of every sample, NFM
//      against the previous sample (which another work item filtered, hence
//      the barrier before), the CW beat at the sample's own DDS index;
//   3. the per-channel walk over the Ta samples (channelizer.cuh
//      agc_walk_all, without power and waterfall): 128 channels are only
//      four warps, so each channel's samples are cut into S time segments
//      (kernels/walk_plan.py) walked as (channel, segment) items in up to
//      four passes, each segment's carries composed exactly from the
//      summaries of the segments before it.
//
// Two forms of one kernel (kChain), the same arithmetic in the same order:
//
//   * the per-channel form (rf_ols_demod, FusedOlsDemod.forward, the
//     reference's call): the caller gathers each channel's response row and
//     AGC constants, packs the 7-row carry and reads (Ta, C) audio;
//   * the chain's form (rf_ols_demod_chain, FusedOlsDemod.call_chain, the
//     flagship's back end in RxChain): the kernel reads each channel's row of
//     the bank's response table by its mode (SAM shares AM's, as
//     ops/demod.py filter_index), its AGC constants from the per-mode tables
//     and the carry from the state's own tensors, where they lie; it writes
//     the new carry in the state's form, the advanced CW DDS phase, the last
//     gain, and (C, Ta) audio straight from the walk (channel-major, as K5's
//     single-pass chain). So the back end is one graph node, where the glue
//     around the per-channel form (the gathers, the carry's stack and
//     unpacking, the phase and gain updates, ~20 small ops) was 20 more.
//     Phase one's item of frame 0 gathers the channel's constants and packs
//     its carry into scratch that the later phases read after their barriers.
//
// Bound: device-memory bytes (x, tail and h_sel in, audio out: ~7.9 MB at
// C = 128, Ta = 4096, nfft = 1024, ~2.4 us at 3.35 TB/s). The scratch round
// trip (16 B per sample) and the walk's grid barriers are what remain.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSAM = 5;  // ops/demod.py SAM: filtered by AM's row

// The chain's form: RxChain's tables and state, read where they lie, and its
// outputs beside DemodArgs' (whose rel/al/tgt/mg/cw_word then point into
// `consts` and st_in into `carry`, both filled by phase one).
struct ChainArgs {
  const float* rel;    // (modes,) per-mode tables (ops/agc.py AgcBank)
  const float* al;
  const float* tgt;
  const float* mg;
  const float* am;     // (2, C) the AM DC block's carry
  const float2* nfm;   // (C,) the NFM discriminator's last sample
  const float* env;    // (C,) the release env
  const float* lpf;    // (C,) the attack lpf
  float* consts;       // (5, C) scratch: rel, al, tgt, mg and the CW word (bits)
  float* carry;        // (7, C) scratch: the carry rows the walk reads
  float2* nfm_out;     // (C,)
  int* cw_out;         // (C,) cw_acc + cw_word Ta, wrapped
  int cw_word;         // the CW tone's DDS word, every channel's
};

// Phase one's item (c, frame 0): channel c's constants by its mode, its
// carry packed as the walk reads it (row 6, the power, 0: passed through),
// and its DDS phase after the block.
__device__ __forceinline__ void chain_prologue(const rf::DemodArgs& a, const ChainArgs& k,
                                               int c) {
  const int C = a.M;
  const int m = a.mode[c];
  k.consts[c] = k.rel[m];
  k.consts[C + c] = k.al[m];
  k.consts[2 * C + c] = k.tgt[m];
  k.consts[3 * C + c] = k.mg[m];
  reinterpret_cast<int*>(k.consts)[4 * C + c] = k.cw_word;
  const float2 nfm = k.nfm[c];
  k.carry[c] = k.am[c];
  k.carry[C + c] = k.am[C + c];
  k.carry[2 * C + c] = nfm.x;
  k.carry[3 * C + c] = nfm.y;
  k.carry[4 * C + c] = k.env[c];
  k.carry[5 * C + c] = k.lpf[c];
  k.carry[6 * C + c] = 0.f;
  k.cw_out[c] = static_cast<int>(static_cast<uint32_t>(a.cw_acc[c]) +
                                 static_cast<uint32_t>(k.cw_word) * static_cast<uint32_t>(a.F));
}

// threads per block: kThreads, or one frame's threads where that is more
constexpr int block_threads(int nfft) {
  return rf::fft_threads(nfft) > kThreads ? rf::fft_threads(nfft) : kThreads;
}

// kMaxThreads: the launch bound, 256 (up to 255 registers a thread: the walk
// in phase three does not spill) unless one frame needs more threads. kChain:
// the chain's form (h: the (rows, nfft) response table), else the
// per-channel form (h: the (C, nfft) selected responses; ch unused).
template <int kMaxThreads, bool kChain>
__global__ void __launch_bounds__(kMaxThreads)
ols_demod_kernel(const float2* __restrict__ x, const float2* __restrict__ tail,
                 const float2* __restrict__ h, const float2* __restrict__ tw,
                 float* __restrict__ sr, float* __restrict__ si, int nfft, int hop,
                 rf::DemodArgs a, ChainArgs ch) {
  extern __shared__ float2 smem[];
  const int C = a.M;
  const int Ta = a.F;
  const int L1 = nfft - hop;
  const int frames = Ta / hop;
  const float scale = 1.f / static_cast<float>(nfft);
  const int T = rf::fft_threads(nfft);
  const int G = blockDim.x / T;
  const int g = threadIdx.x / T;
  const int ft = threadIdx.x - g * T;  // this thread's index in its frame
  float2* tws = smem;
  float2* ex = smem + rf::fft_twiddle_points(nfft) + g * rf::fft_exchange_points(nfft);
  rf::stage_twiddles(tws, tw, nfft);

  const long long items = static_cast<long long>(C) * frames;
  for (long long base = static_cast<long long>(blockIdx.x) * G; base < items;
       base += static_cast<long long>(gridDim.x) * G) {
    const long long item = base + g;
    const bool live = item < items;
    const int c = live ? static_cast<int>(item / frames) : 0;
    const int f = live ? static_cast<int>(item - static_cast<long long>(c) * frames) : 0;
    const float2* xc = x + static_cast<long long>(c) * Ta;
    const float2* tc = tail + static_cast<long long>(c) * L1;
    const float2* hc;
    if constexpr (kChain) {
      const int m = a.mode[c];
      hc = h + static_cast<long long>(m == kSAM ? rf::kAM : m) * nfft;
      if (live && f == 0 && ft == 0) chain_prologue(a, ch, c);
    } else {
      hc = h + static_cast<long long>(c) * nfft;
    }
    float2 v[rf::kFftP];
#pragma unroll
    for (int m = 0; m < rf::kFftP; ++m) {
      const int n = f * hop + ft + T * m - L1;
      v[m] = m < nfft && live ? (n < 0 ? tc[n + L1] : xc[n]) : make_float2(0.f, 0.f);
    }
    rf::fft(v, ex, tws, nfft, ft);
#pragma unroll
    for (int m = 0; m < rf::kFftP; ++m) {
      const float2 Hk = m < nfft && live ? hc[ft + T * m] : make_float2(0.f, 0.f);
      const float2 X = v[m];
      v[m] = make_float2(X.x * Hk.x - X.y * Hk.y, -(X.x * Hk.y + X.y * Hk.x));
    }
    rf::fft(v, ex, tws, nfft, ft);
    if (!live) continue;
#pragma unroll
    for (int m = 0; m < rf::kFftP; ++m) {
      const int k = ft + T * m;
      if (m < nfft && k >= L1) {
        const long long i = (static_cast<long long>(f) * hop + (k - L1)) * C + c;
        sr[i] = v[m].x * scale;
        si[i] = -v[m].y * scale;
      }
    }
  }
  rf::grid_barrier(a.barrier);

  const long long n = static_cast<long long>(Ta) * C;
  const bool nfm = rf::enabled(a.en, rf::kNFM);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = i / C;
    const int c = static_cast<int>(i - t * C);
    const float xr = __ldcg(sr + i), xi = __ldcg(si + i);
    float pr, pi;
    if (t > 0) {
      pr = __ldcg(sr + i - C);
      pi = __ldcg(si + i - C);
    } else if constexpr (kChain) {
      pr = ch.nfm[c].x;
      pi = ch.nfm[c].y;
    } else {
      pr = a.st_in[2 * C + c];
      pi = a.st_in[3 * C + c];
    }
    a.v[i] = rf::demod_value(a, c, t, xr, xi, pr, pi);
    a.p[i] = xr * xr + xi * xi;
    if constexpr (kChain) {
      if (t == Ta - 1) ch.nfm_out[c] = nfm ? make_float2(xr, xi) : ch.nfm[c];
    } else if (nfm && t == Ta - 1) {
      a.st_out[2 * C + c] = xr;
      a.st_out[3 * C + c] = xi;
    }
  }
  rf::grid_barrier(a.barrier + 1);
  // the chain's form: (C, Ta) audio through tiles in phase one's shared
  // memory, and the last gain as row 7 of st_out
  if constexpr (kChain)
    rf::agc_walk_all<true, true>(a, a.barrier + 2, reinterpret_cast<float*>(smem));
  else
    rf::agc_walk_all(a, a.barrier + 2);
}

// The launch: block threads, dynamic shared memory, the grid (the
// (channel, frame) groups phase one wants, capped by residency), and the
// instantiation.
struct Launch {
  int threads, grid;
  size_t smem;
  void* kernel;
};

// l's instantiation, and how many of its blocks stay resident
template <int kMaxThreads, bool kChain>
cudaError_t resident(Launch* l, int* blocks) {
  l->kernel = reinterpret_cast<void*>(ols_demod_kernel<kMaxThreads, kChain>);
  return rf::resident_blocks<ols_demod_kernel<kMaxThreads, kChain>>(l->threads, l->smem,
                                                                     blocks);
}

cudaError_t launch_shape(int C, int Ta, int nfft, int hop, bool chain, Launch* l) {
  l->threads = block_threads(nfft);
  const int G = l->threads / rf::fft_threads(nfft);
  l->smem = sizeof(float2) * (rf::fft_twiddle_points(nfft) +
                              static_cast<size_t>(G) * rf::fft_exchange_points(nfft));
  if (chain && l->smem < rf::walk_tile_bytes(l->threads))
    l->smem = rf::walk_tile_bytes(l->threads);
  const bool wide = l->threads > kThreads;
  int blocks = 0;
  cudaError_t err = wide ? (chain ? resident<512, true>(l, &blocks)
                                  : resident<512, false>(l, &blocks))
                         : (chain ? resident<kThreads, true>(l, &blocks)
                                  : resident<kThreads, false>(l, &blocks));
  if (err != cudaSuccess) return err;
  const long long groups = (static_cast<long long>(C) * (Ta / hop) + G - 1) / G;
  l->grid = static_cast<int>(groups < blocks ? groups : blocks);
  return cudaSuccess;
}

// The launch's thread count (grid times block) at (C, Ta, nfft, hop) in
// either form. Returns the CUDA error.
int threads_of(int C, int Ta, int nfft, int hop, bool chain, int* threads) {
  Launch l{};
  const cudaError_t err = launch_shape(C, Ta, nfft, hop, chain, &l);
  *threads = l.grid * l.threads;
  return static_cast<int>(err);
}

// Checks the walk's plan, shapes the launch and launches either form.
int launch(const void* x, const void* tail, const void* h, const void* tw, float* sr, float* si,
           int nfft, int hop, rf::DemodArgs a, ChainArgs k, bool chain, void* stream) {
  if (!rf::walk_plan_ok(a.F, a.S, 0) || (a.S > 1 && a.seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{};
  cudaError_t err = launch_shape(a.M, a.F, nfft, hop, chain, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* x2 = static_cast<const float2*>(x);
  const float2* t2 = static_cast<const float2*>(tail);
  const float2* h2 = static_cast<const float2*>(h);
  const float2* w2 = static_cast<const float2*>(tw);
  void* args[] = {&x2, &t2, &h2, &w2, &sr, &si, &nfft, &hop, &a, &k};
  err = cudaLaunchCooperativeKernel(l.kernel, dim3(l.grid), dim3(l.threads), args, l.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch's thread count (grid times block) at (C, Ta, nfft, hop), for
// the walk's plan (kernels/walk_plan.py): rf_ols_demod's, and
// rf_ols_demod_chain's. Returns the CUDA error.
int rf_ols_demod_threads(int C, int Ta, int nfft, int hop, int* threads) {
  return threads_of(C, Ta, nfft, hop, false, threads);
}

int rf_ols_demod_chain_threads(int C, int Ta, int nfft, int hop, int* threads) {
  return threads_of(C, Ta, nfft, hop, true, threads);
}

// The per-channel form. Returns the CUDA error of the launch (0 =
// launched). barrier points to 2 + rf::kWalkCounters zeroed words: one for
// each of phases one and two's grid barriers, then the walk's; wf is not
// written (no waterfall on this path). tw is the FFT's twiddle table
// (kernels/fft_plan.py). S: the walk's time segments, seg its (4, S, C)
// summaries (null when S = 1). audio is (Ta, C).
int rf_ols_demod(const void* x, const void* tail, const void* h_sel, const void* tw, float* sr,
                 float* si, const int* mode, const int* cw_word, const int* cw_acc,
                 const float* rel, const float* al, const float* tgt, const float* mg,
                 const float* st_in, float* audio, float* wf, float* st_out, float* v, float* p,
                 unsigned int* barrier, int C, int Ta, int nfft, int hop, int en,
                 float dev_scale, float cw_scale, int S, float* seg, void* stream) {
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, nullptr, C, Ta, en, 0, rf::kAgcApply, dev_scale, cw_scale, S, seg};
  return launch(x, tail, h_sel, tw, sr, si, nfft, hop, a, ChainArgs{}, false, stream);
}

// The chain's form, as rf_ols_demod but: H is the bank's (rows, nfft)
// response table, each channel's row chosen by its mode; rel, al, tgt, mg the
// (modes,) per-mode AGC tables; cw_word the CW tone's word; am (2, C), nfm
// (C,) complex, env and lpf (C,) the state's carry; consts (5, C) and carry
// (7, C) scratch; out: audio (C, Ta), st_out (8, C) (rows 0-1 the AM carry,
// 4 env, 5 lpf, 7 the last gain), nfm_out (C,) complex, cw_out (C,) the DDS
// phase after the block.
int rf_ols_demod_chain(const void* x, const void* tail, const void* H, const void* tw,
                       float* sr, float* si, const int* mode, const int* cw_acc,
                       const float* rel, const float* al, const float* tgt, const float* mg,
                       int cw_word, const float* am, const void* nfm, const float* env,
                       const float* lpf, float* consts, float* carry, float* audio,
                       float* st_out, void* nfm_out, int* cw_out, float* v, float* p,
                       unsigned int* barrier, int C, int Ta, int nfft, int hop, int en,
                       float dev_scale, float cw_scale, int S, float* seg, void* stream) {
  rf::DemodArgs a{mode, reinterpret_cast<const int*>(consts + 4 * C), cw_acc, consts,
                  consts + C, consts + 2 * C, consts + 3 * C, carry, audio, nullptr, st_out, v,
                  p, barrier, nullptr, C, Ta, en, 0, rf::kAgcApply, dev_scale, cw_scale, S, seg};
  ChainArgs k{rel, al, tgt, mg, am, static_cast<const float2*>(nfm), env, lpf, consts, carry,
              static_cast<float2*>(nfm_out), cw_out, cw_word};
  return launch(x, tail, H, tw, sr, si, nfft, hop, a, k, true, stream);
}

}  // extern "C"
