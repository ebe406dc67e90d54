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
//   * phase one: each block owns a run of frames. It computes the
//     polyphase frame and the FFT of each in shared memory (and of the frame
//     before its run, for the NFM lookback), then writes |X|^2 and the
//     demod value of every element to two (F, M) scratch planes. The
//     complex channel planes themselves never reach device memory, but
//     their demod values do (8 B per element, written and read once).
//   * phase two: the per-channel walk of demod_agc.cu (AM DC block, release,
//     attack, gain, power, waterfall), exact and sequential per channel.
//
// Bound: device-memory bytes. Input once (8 B per sample), audio (4 B per
// element) and waterfall out: ~101 MB at M = 4096, F = 2048, ~30 us at
// 3.35 TB/s. The scratch round trip, the FFT's barriers and the 128-warp
// walk are what a later PR can cut.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
channelizer_one_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                       long long xs, const float2* __restrict__ tail,
                       const float* __restrict__ h, const float2* __restrict__ tw, int log2m,
                       int K, rf::DemodArgs a) {
  extern __shared__ float2 smem[];
  float2* buf = smem;          // [M] the frame being transformed
  float2* prev = smem + a.M;   // [M] the previous frame, for the NFM lookback
  const int M = a.M;
  const int chunk = (a.F + gridDim.x - 1) / gridDim.x;
  const long long fa = static_cast<long long>(blockIdx.x) * chunk;
  const long long fb = fa + chunk < a.F ? fa + chunk : a.F;
  const bool nfm = rf::enabled(a.en, rf::kNFM);
  if (fa < a.F) {
    for (long long f = fa > 0 ? fa - 1 : 0; f < fb; ++f) {
      rf::pfb_fft_frame(xr, xi, xs, tail, h, tw, M, log2m, K, f, buf);
      for (int c = threadIdx.x; c < M; c += blockDim.x) {  // each thread owns its channels
        const float2 x = buf[c];
        if (f >= fa) {
          float pr, pi;
          if (f > 0) {
            pr = prev[c].x;
            pi = prev[c].y;
          } else {
            pr = a.st_in[2 * M + c];
            pi = a.st_in[3 * M + c];
          }
          const long long i = f * M + c;
          a.v[i] = rf::demod_value(a, c, f, x.x, x.y, pr, pi);
          a.p[i] = x.x * x.x + x.y * x.y;
          if (nfm && f == a.F - 1) {
            a.st_out[2 * M + c] = x.x;
            a.st_out[3 * M + c] = x.y;
          }
        }
        prev[c] = x;
      }
    }
  }
  rf::grid_barrier(a.barrier);
  rf::agc_walk_all(a);
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = launched). frames_per_block sets
// the phase-one run length (and so the grid), capped by residency.
int rf_channelizer_one(const float* xr, const float* xi, long long xs, const void* tail,
                       const float* h, const void* tw, const int* mode, const int* cw_word,
                       const int* cw_acc, const float* rel, const float* al, const float* tgt,
                       const float* mg, const float* st_in, float* audio, float* wf,
                       float* st_out, float* v, float* p, unsigned int* barrier, int M,
                       int log2m, int K, int F, int en, int wf_avg, int apply_agc,
                       float dev_scale, float cw_scale, int frames_per_block, void* stream) {
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, M, F, en, wf_avg, apply_agc, dev_scale, cw_scale};
  const size_t smem = 2 * sizeof(float2) * static_cast<size_t>(M);
  cudaError_t err = cudaFuncSetAttribute(channelizer_one_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, channelizer_one_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (F + frames_per_block - 1) / frames_per_block;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  const float2* tl = static_cast<const float2*>(tail);
  const float2* t2 = static_cast<const float2*>(tw);
  void* args[] = {&xr, &xi, &xs, &tl, &h, &t2, &log2m, &K, &a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(channelizer_one_kernel), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
