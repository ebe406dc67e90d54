// The whole channelizer in one launch, for Hopper: K-tap polyphase + M-point
// FFT + demod bank + attack/release AGC + power and averaged waterfall.
//
// Replaces the Pallas TPU kernel radioframe/kernels/channelizer_one.py::_kernel
// (driven by FusedChannelizerOne.call_planes), the composition of
// pfb_dft.cu and demod_agc.cu. The TPU kernel keeps the (F, M) channel
// planes in VMEM: each step of its sequential grid filters, transforms and
// demodulates one frame tile while carrying both histories in scratch. A GPU
// has no sequential grid, and one block cannot hold the 4096 channels'
// recurrences without serializing the card, so this is one cooperative
// launch in two phases split by a grid barrier:
//
//   * phase one: each run of frames (a frame group of a block: blockDim /
//     (M/16) groups of M/16 threads) computes the polyphase frame and the FFT
//     of each (rf::fft, the register-resident Stockham FFT of
//     channelizer.cuh; and of the frame before its run, for the NFM
//     lookback), then writes |X|^2 and the demod value of every element to
//     two (F, M) scratch planes. Each thread owns the same 16 channels in
//     every frame, so the previous frame's values wait in a per-thread slice
//     of shared memory with no barrier. The complex channel planes never
//     reach device memory, but their demod values do (8 B per element,
//     written and read once).
//   * phase two: the per-channel walk (AM DC block, release, attack, gain,
//     power, waterfall), rf::agc_walk_all: (channel, time segment) items in
//     up to four passes split by grid barriers, each segment's carries
//     composed exactly from the summaries of the segments before it
//     (channelizer.cuh; the plan, S segments, from kernels/walk_plan.py).
//
// The emit_env variant (the reference's static emit_env flag, served to the
// sharded channelizer's "emit_env" tier) runs demod-only and has the walk
// store each frame's zero-entering release env as a fifth output.
//
// The audio's layout is the caller's: frame-major (F, M), as K4 writes it and
// the sharded paths and emit_env read it, or channel-major (M, F), which the
// single-pass chain returns: the walk's final pass stages a warp's 32 channels
// x 32 frames in phase one's shared memory and stores channel rows, so no
// transposed copy of the audio follows the kernel (at M = 4096, F = 2048 that
// copy read and wrote 32 MB in 0.072 ms a block, a ninth of the step; PERF.md).
// The two layouts are two instantiations (kChannelMajor): the same values in
// the same order, at other addresses.
//
// Bound: device-memory bytes. Input once (8 B per sample), audio (4 B per
// element) and waterfall out: ~101 MB at M = 4096, F = 2048, ~30 us at
// 3.35 TB/s; emit_env adds the env (4 B per element). Measured on an H100
// SXM at 700 W (PERF.md): 0.49 ms, of which the walk ~0.12 and the demod
// values ~0.10 (the CW sincosf and the NFM atan2f, the modes interleaved
// across a warp's channels); the lookback FFT is nearly free (its step does
// no demod). Two redesigns of phase one measured slower and are not built
// here: K3's cluster walk (pfb_dft.cu; 0.56 against 0.49 ms: clusters of 8
// leave SMs idle, so the walk runs on fewer threads, and three cluster
// barriers a step), and the runs without the lookback FFT, each run's first
// NFM value handed over from the previous run (0.54 against 0.49 ms: any
// state added to the loop spills at the 128 registers of two blocks an SM).
// What is left to cut: the demod's divergence, the scratch round trip (each
// walk pass reads v or p again, 32 MB a plane at M = 4096, F = 2048: more
// than L2 keeps) and the polyphase's L2 re-reads. Gone: the transposed copy of
// the audio after the kernel (channel-major audio, above).

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;

// kMaxThreads: the launch bound, 256 (up to 255 registers a thread: neither
// phase spills) unless one frame needs more threads (M > 4096); kChannelMajor:
// the audio is (M, F), else (F, M)
template <int kMaxThreads, bool kChannelMajor>
__global__ void __launch_bounds__(kMaxThreads)
channelizer_one_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       long long xs, const float2* __restrict__ tail,
                       const float* __restrict__ h, const float2* __restrict__ tw, int K,
                       rf::DemodArgs a) {
  extern __shared__ float2 smem[];
  const int M = a.M;
  const int T = rf::fft_threads(M);
  const int G = blockDim.x / T;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  float2* tws = smem;                                      // the FFT's twiddles
  float2* ex = tws + rf::fft_twiddle_points(M) + g * rf::fft_exchange_points(M);
  float2* prev = tws + rf::fft_twiddle_points(M) + G * rf::fft_exchange_points(M) + g * M;
  rf::stage_twiddles(tws, tw, M);
  const int runs = gridDim.x * G;
  const int chunk = (a.F + runs - 1) / runs;
  const long long fa = static_cast<long long>(blockIdx.x * G + g) * chunk;
  const long long fb = fa + chunk < a.F ? fa + chunk : a.F;
  const bool nfm = rf::enabled(a.en, rf::kNFM);
  // every group runs chunk + 1 steps (the FFT holds block barriers): the
  // frame before its run, then the run; steps out of range store nothing
  for (int i = 0; i <= chunk; ++i) {
    const long long f = fa - 1 + i;
    const bool live = f >= 0 && f < fb;
    float2 v[rf::kFftP];
    if (live) {
      rf::pfb_frame(v, xr, xi, xs, tail, h, M, K, f, t);
    } else {
#pragma unroll
      for (int m = 0; m < rf::kFftP; ++m) v[m] = make_float2(0.f, 0.f);
    }
    rf::fft(v, ex, tws, M, t);
    if (!live) continue;
#pragma unroll
    for (int m = 0; m < rf::kFftP; ++m) {  // each thread owns its channels
      const int c = t + T * m;
      if (m >= M) break;
      const float2 x = v[m];
      if (f >= fa) {
        float pr, pi;
        if (f > 0) {
          pr = prev[c].x;
          pi = prev[c].y;
        } else {
          pr = a.st_in[2 * M + c];
          pi = a.st_in[3 * M + c];
        }
        const long long e = f * M + c;
        a.v[e] = rf::demod_value(a, c, f, x.x, x.y, pr, pi);
        a.p[e] = x.x * x.x + x.y * x.y;
        if (nfm && f == a.F - 1) {
          a.st_out[2 * M + c] = x.x;
          a.st_out[3 * M + c] = x.y;
        }
      }
      prev[c] = x;
    }
  }
  rf::grid_barrier(a.barrier);
  // phase one's shared memory holds the walk's channel-major tiles
  rf::agc_walk_all<kChannelMajor>(a, a.barrier + 1, reinterpret_cast<float*>(smem));
}

// The launch: block threads, dynamic shared memory, the grid (the frame
// runs phase one wants, capped by residency), and the instantiation.
struct Launch {
  int threads, grid;
  size_t smem;
  void* kernel;
};

// l's instantiation, and how many of its blocks stay resident
template <int kMaxThreads, bool kChannelMajor>
cudaError_t resident(Launch* l, int* blocks) {
  l->kernel = reinterpret_cast<void*>(channelizer_one_kernel<kMaxThreads, kChannelMajor>);
  return rf::resident_blocks<channelizer_one_kernel<kMaxThreads, kChannelMajor>>(
      l->threads, l->smem, blocks);
}

cudaError_t launch_shape(int M, int F, int frames_per_block, bool channel_major, Launch* l) {
  l->threads = rf::fft_threads(M) < 32 ? 32 : rf::fft_threads(M);
  const int G = l->threads / rf::fft_threads(M);
  l->smem = sizeof(float2) * (rf::fft_twiddle_points(M) +
                              static_cast<size_t>(G) * (rf::fft_exchange_points(M) + M));
  if (channel_major && l->smem < rf::walk_tile_bytes(l->threads))
    l->smem = rf::walk_tile_bytes(l->threads);
  const bool wide = l->threads > kThreads;
  int blocks = 0;
  cudaError_t err = wide ? (channel_major ? resident<512, true>(l, &blocks)
                                          : resident<512, false>(l, &blocks))
                         : (channel_major ? resident<kThreads, true>(l, &blocks)
                                          : resident<kThreads, false>(l, &blocks));
  if (err != cudaSuccess) return err;
  const int per_block = frames_per_block * G;
  const int want = (F + per_block - 1) / per_block;
  l->grid = want < blocks ? want : blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch's resources on the current device at M (rf::occupancy's eight
// values: registers, blocks per SM, clusters (0), cluster size (0), threads,
// shared bytes, local bytes, SMs), as kernels/pfb_plan.py reads them.
int rf_channelizer_one_occupancy(int M, int* out) {
  Launch l{};
  const cudaError_t err = launch_shape(M, 1, 1, false, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      l.threads > kThreads
          ? rf::occupancy(channelizer_one_kernel<512, false>, l.threads, l.smem, 0, out)
          : rf::occupancy(channelizer_one_kernel<kThreads, false>, l.threads, l.smem, 0, out));
}

// The launch's thread count (grid times block) at (M, F, frames_per_block,
// channel_major), for the walk's plan (kernels/walk_plan.py). Returns the
// CUDA error.
int rf_channelizer_one_threads(int M, int F, int frames_per_block, int channel_major,
                               int* threads) {
  Launch l{};
  const cudaError_t err = launch_shape(M, F, frames_per_block, channel_major != 0, &l);
  *threads = l.grid * l.threads;
  return static_cast<int>(err);
}

// Returns the CUDA error of the launch (0 = launched). frames_per_block sets
// the phase-one run length (and so the grid), capped by residency. env is
// the (F, M) release-env output of agc = kAgcEmitEnv, else null. barrier:
// 1 + rf::kWalkCounters zeroed words. S: the walk's time segments, seg its
// (4, S, M) summaries (null when S = 1). channel_major: audio is (M, F), else
// (F, M).
int rf_channelizer_one(const float* xr, const float* xi, long long xs, const void* tail,
                       const float* h, const void* tw, const int* mode, const int* cw_word,
                       const int* cw_acc, const float* rel, const float* al, const float* tgt,
                       const float* mg, const float* st_in, float* audio, float* wf,
                       float* st_out, float* v, float* p, unsigned int* barrier, float* env,
                       int M, int K, int F, int en, int wf_avg, int agc,
                       float dev_scale, float cw_scale, int frames_per_block, int S, float* seg,
                       int channel_major, void* stream) {
  if (!rf::walk_plan_ok(F, S, wf_avg) || (S > 1 && seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, env, M, F, en, wf_avg, agc, dev_scale, cw_scale, S, seg};
  Launch l{};
  cudaError_t err = launch_shape(M, F, frames_per_block, channel_major != 0, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* tl = static_cast<const float2*>(tail);
  const float2* t2 = static_cast<const float2*>(tw);
  void* args[] = {&xr, &xi, &xs, &tl, &h, &t2, &K, &a};
  err = cudaLaunchCooperativeKernel(l.kernel, dim3(l.grid), dim3(l.threads), args, l.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
