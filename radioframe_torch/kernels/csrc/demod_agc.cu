// Demod bank (SSB/LSB/CW/AM/NFM) + attack/release AGC + power and averaged
// waterfall power over the channelizer's (F, M) planes, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/demod_agc.py::_kernel
// (driven by FusedDemodAgc.__call__). Same function, rethought for a GPU:
//
//   * The TPU kernel walks frame tiles on a sequential grid and turns every
//     recurrence into matrix products (the AM DC block and the attack
//     one-pole as triangular a^{g-j} matmuls, the release max-decay as an
//     a^{-f} rescale plus a log-step cummax). On the GPU a thread walks one
//     channel's frames in order with the carries in registers: exact, and
//     with no rescale bound on the release.
//   * 4096 channels fill only 128 warps, one per SM, so the walk is slow
//     per element, and the work that needs no recurrence runs first over
//     the whole grid: phase one computes |X|^2 and the demod value of every
//     element (2 Re, the CW beat from the uint32 DDS, the NFM discriminator
//     with atan2f against the previous frame) into two (F, M) scratch
//     planes. A grid
//     barrier (cooperative launch, all blocks resident) separates it from
//     phase two, the per-channel walk: AM DC block, release, attack, gain
//     clip with the NFM bypass, power sum and waterfall lines.
//   * agc = kAgcOff is the demod-only form (the hang route): audio before
//     gain, carry rows 4 and 5 passed through. K4 takes kAgcOff or
//     kAgcApply; kAgcEmitEnv is K5's alone (K4 has no env output).
//   * Bound: device-memory bytes. Planes in (8 B per element), audio out
//     (4 B) and waterfall out: ~101 MB at M = 4096, F = 2048, ~30 us at
//     3.35 TB/s. The scratch round trip adds 16 B per element, and the walk,
//     paced by its dependent instructions on one warp per SM, takes most of
//     the time. K4 runs rf::agc_walk_all with S = 1 at compile time (one
//     item per channel, the sequential walk, at its own registers); its own
//     time-segment plan, as K5 and K6 have, is still to come.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
demod_agc_kernel(const float* __restrict__ yr, const float* __restrict__ yi, rf::DemodArgs a) {
  const long long n = static_cast<long long>(a.F) * a.M;
  const bool nfm = rf::enabled(a.en, rf::kNFM);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long f = i / a.M;
    const int c = static_cast<int>(i - f * a.M);
    const float xr = yr[i], xi = yi[i];
    float pr, pi;
    if (f > 0) {
      pr = yr[i - a.M];
      pi = yi[i - a.M];
    } else {
      pr = a.st_in[2 * a.M + c];
      pi = a.st_in[3 * a.M + c];
    }
    a.v[i] = rf::demod_value(a, c, f, xr, xi, pr, pi);
    a.p[i] = xr * xr + xi * xi;
    if (nfm && f == a.F - 1) {
      a.st_out[2 * a.M + c] = xr;
      a.st_out[3 * a.M + c] = xi;
    }
  }
  rf::grid_barrier(a.barrier);
  rf::agc_walk_all<false>(a, nullptr);  // S = 1: the sequential walk alone
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = launched).
int rf_demod_agc(const float* yr, const float* yi, const int* mode, const int* cw_word,
                 const int* cw_acc, const float* rel, const float* al, const float* tgt,
                 const float* mg, const float* st_in, float* audio, float* wf, float* st_out,
                 float* v, float* p, unsigned int* barrier, int M, int F, int en, int wf_avg,
                 int agc, float dev_scale, float cw_scale, void* stream) {
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, nullptr, M, F, en, wf_avg, agc, dev_scale, cw_scale, 1, nullptr};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, demod_agc_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (static_cast<long long>(M) * F + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(work < static_cast<long long>(sms) * per_sm
                                        ? work : static_cast<long long>(sms) * per_sm);
  void* args[] = {&yr, &yi, &a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(demod_agc_kernel), dim3(grid),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
