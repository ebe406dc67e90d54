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
// Bound: device-memory bytes (x, tail and h_sel in, audio out: ~7.9 MB at
// C = 128, Ta = 4096, nfft = 1024, ~2.4 us at 3.35 TB/s). The scratch round
// trip (16 B per sample) and the walk's grid barriers are what remain.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;

// threads per block: kThreads, or one frame's threads where that is more
constexpr int block_threads(int nfft) {
  return rf::fft_threads(nfft) > kThreads ? rf::fft_threads(nfft) : kThreads;
}

// kMaxThreads: the launch bound, 256 (up to 255 registers a thread: the walk
// in phase three does not spill) unless one frame needs more threads
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
ols_demod_kernel(const float2* __restrict__ x, const float2* __restrict__ tail,
                 const float2* __restrict__ h_sel, const float2* __restrict__ tw,
                 float* __restrict__ sr, float* __restrict__ si, int nfft, int hop,
                 rf::DemodArgs a) {
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
    const float2* hc = h_sel + static_cast<long long>(c) * nfft;
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
    } else {
      pr = a.st_in[2 * C + c];
      pi = a.st_in[3 * C + c];
    }
    a.v[i] = rf::demod_value(a, c, t, xr, xi, pr, pi);
    a.p[i] = xr * xr + xi * xi;
    if (nfm && t == Ta - 1) {
      a.st_out[2 * C + c] = xr;
      a.st_out[3 * C + c] = xi;
    }
  }
  rf::grid_barrier(a.barrier + 1);
  rf::agc_walk_all(a, a.barrier + 2);
}

// The launch: block threads, dynamic shared memory, and the grid (the
// (channel, frame) groups phase one wants, capped by residency).
struct Launch {
  int threads, grid;
  size_t smem;
  bool wide;
};

cudaError_t launch_shape(int C, int Ta, int nfft, int hop, Launch* l) {
  l->threads = block_threads(nfft);
  const int G = l->threads / rf::fft_threads(nfft);
  l->smem = sizeof(float2) * (rf::fft_twiddle_points(nfft) +
                              static_cast<size_t>(G) * rf::fft_exchange_points(nfft));
  l->wide = l->threads > kThreads;
  int resident = 0;
  cudaError_t err =
      l->wide ? rf::resident_blocks<ols_demod_kernel<512>>(l->threads, l->smem, &resident)
              : rf::resident_blocks<ols_demod_kernel<kThreads>>(l->threads, l->smem, &resident);
  if (err != cudaSuccess) return err;
  const long long groups = (static_cast<long long>(C) * (Ta / hop) + G - 1) / G;
  l->grid = static_cast<int>(groups < resident ? groups : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch's thread count (grid times block) at (C, Ta, nfft, hop), for
// the walk's plan (kernels/walk_plan.py). Returns the CUDA error.
int rf_ols_demod_threads(int C, int Ta, int nfft, int hop, int* threads) {
  Launch l{};
  const cudaError_t err = launch_shape(C, Ta, nfft, hop, &l);
  *threads = l.grid * l.threads;
  return static_cast<int>(err);
}

// Returns the CUDA error of the launch (0 = launched). barrier points to
// 2 + rf::kWalkCounters zeroed words: one for each of phases one and two's
// grid barriers, then the walk's; wf is not written (no waterfall on this
// path). tw is the FFT's twiddle table (kernels/fft_plan.py). S: the walk's
// time segments, seg its (4, S, C) summaries (null when S = 1).
int rf_ols_demod(const void* x, const void* tail, const void* h_sel, const void* tw, float* sr,
                 float* si, const int* mode, const int* cw_word, const int* cw_acc,
                 const float* rel, const float* al, const float* tgt, const float* mg,
                 const float* st_in, float* audio, float* wf, float* st_out, float* v, float* p,
                 unsigned int* barrier, int C, int Ta, int nfft, int hop, int en,
                 float dev_scale, float cw_scale, int S, float* seg, void* stream) {
  if (!rf::walk_plan_ok(Ta, S, 0) || (S > 1 && seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, nullptr, C, Ta, en, 0, rf::kAgcApply, dev_scale, cw_scale, S, seg};
  Launch l{};
  cudaError_t err = launch_shape(C, Ta, nfft, hop, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* x2 = static_cast<const float2*>(x);
  const float2* t2 = static_cast<const float2*>(tail);
  const float2* h2 = static_cast<const float2*>(h_sel);
  const float2* w2 = static_cast<const float2*>(tw);
  void* args[] = {&x2, &t2, &h2, &w2, &sr, &si, &nfft, &hop, &a};
  void* kernel = l.wide ? reinterpret_cast<void*>(ols_demod_kernel<512>)
                       : reinterpret_cast<void*>(ols_demod_kernel<kThreads>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(l.grid), dim3(l.threads), args, l.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
