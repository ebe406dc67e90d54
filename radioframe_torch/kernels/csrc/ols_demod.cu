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
//   1. one work item per (channel, frame): the window into shared memory in
//      bit-reversed order, a radix-2 FFT (channelizer.cuh), the product with
//      the selected response, conjugated so that a second forward FFT gives
//      the inverse (IFFT(Y) = conj(FFT(conj(Y))) / nfft), and the hop kept
//      samples written to two (Ta, C) time-major scratch planes;
//   2. over the whole grid, |s|^2 and the demod value of every sample, NFM
//      against the previous sample (which another work item filtered, hence
//      the barrier before), the CW beat at the sample's own DDS index;
//   3. one thread per channel walks the Ta samples (channelizer.cuh
//      agc_walk, without power and waterfall).
//
// Bound: device-memory bytes (x, tail and h_sel in, audio out: ~7.9 MB at
// C = 128, Ta = 4096, nfft = 1024, ~2.4 us at 3.35 TB/s). What paces it is
// phase three: 128 threads, four warps, walking 4096 dependent steps; the
// scratch round trip (16 B per sample) is second.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ols_demod_kernel(const float2* __restrict__ x, const float2* __restrict__ tail,
                 const float2* __restrict__ h_sel, const float2* __restrict__ tw,
                 float* __restrict__ sr, float* __restrict__ si, int nfft, int log2n, int hop,
                 rf::DemodArgs a) {
  extern __shared__ float2 smem[];
  float2* buf = smem;          // [nfft] forward transform
  float2* inv = smem + nfft;   // [nfft] inverse transform
  const int C = a.M;
  const int Ta = a.F;
  const int L1 = nfft - hop;
  const int frames = Ta / hop;
  const float scale = 1.f / static_cast<float>(nfft);

  for (long long item = blockIdx.x; item < static_cast<long long>(C) * frames;
       item += gridDim.x) {
    const int c = static_cast<int>(item / frames);
    const int f = static_cast<int>(item - static_cast<long long>(c) * frames);
    const float2* xc = x + static_cast<long long>(c) * Ta;
    const float2* tc = tail + static_cast<long long>(c) * L1;
    const float2* hc = h_sel + static_cast<long long>(c) * nfft;
    __syncthreads();  // the last item may still be reading inv
    for (int k = threadIdx.x; k < nfft; k += blockDim.x) {
      const int n = f * hop + k - L1;
      buf[__brev(k) >> (32 - log2n)] = n < 0 ? tc[n + L1] : xc[n];
    }
    __syncthreads();
    rf::fft_inplace(buf, tw, nfft);
    for (int k = threadIdx.x; k < nfft; k += blockDim.x) {
      const float2 X = buf[k];
      const float2 Hk = hc[k];
      const float yr = X.x * Hk.x - X.y * Hk.y;
      const float yi = X.x * Hk.y + X.y * Hk.x;
      inv[__brev(k) >> (32 - log2n)] = make_float2(yr, -yi);
    }
    __syncthreads();
    rf::fft_inplace(inv, tw, nfft);
    for (int j = threadIdx.x; j < hop; j += blockDim.x) {
      const float2 z = inv[L1 + j];
      const long long i = (static_cast<long long>(f) * hop + j) * C + c;
      sr[i] = z.x * scale;
      si[i] = -z.y * scale;
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
  rf::agc_walk_all(a);
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 = launched). barrier points to two
// zeroed counters, one for each grid barrier; wf is not written (no
// waterfall on this path).
int rf_ols_demod(const void* x, const void* tail, const void* h_sel, const void* tw, float* sr,
                 float* si, const int* mode, const int* cw_word, const int* cw_acc,
                 const float* rel, const float* al, const float* tgt, const float* mg,
                 const float* st_in, float* audio, float* wf, float* st_out, float* v, float* p,
                 unsigned int* barrier, int C, int Ta, int nfft, int log2n, int hop, int en,
                 float dev_scale, float cw_scale, void* stream) {
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, C, Ta, en, 0, 1, dev_scale, cw_scale};
  const size_t smem = 2 * sizeof(float2) * static_cast<size_t>(nfft);
  cudaError_t err = cudaFuncSetAttribute(ols_demod_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ols_demod_kernel, kThreads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = static_cast<long long>(C) * (Ta / hop);
  const int grid = static_cast<int>(items < static_cast<long long>(sms) * per_sm
                                        ? items : static_cast<long long>(sms) * per_sm);
  const float2* x2 = static_cast<const float2*>(x);
  const float2* t2 = static_cast<const float2*>(tail);
  const float2* h2 = static_cast<const float2*>(h_sel);
  const float2* w2 = static_cast<const float2*>(tw);
  void* args[] = {&x2, &t2, &h2, &w2, &sr, &si, &nfft, &log2n, &hop, &a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ols_demod_kernel), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
