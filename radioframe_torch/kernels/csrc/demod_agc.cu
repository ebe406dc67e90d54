// Demod bank (SSB/LSB/CW/AM/NFM) + attack/release AGC + power and averaged
// waterfall power over the channelizer's (F, M) planes, for Hopper.
//
// Replaces the Pallas TPU kernel radioframe/kernels/demod_agc.py::_kernel
// (driven by FusedDemodAgc.__call__). Same function, rethought for a GPU:
//
//   * The TPU kernel walks frame tiles on a sequential grid and turns every
//     recurrence into matrix products (the AM DC block and the attack
//     one-pole as triangular a^{g-j} matmuls, the release max-decay as an
//     a^{-f} rescale plus a log-step cummax). On the GPU the recurrences run
//     as rf::agc_walk_all, the walk K5 and K6 share: each channel's frames
//     cut into S time segments (kernels/walk_plan.py plans S from this
//     launch's thread count, which rf_demod_agc_threads reports), the
//     (channel, segment) items walked in up to four passes a grid barrier
//     apart, each segment's carries composed from the summaries of the
//     segments before it. At M = 4096, F = 2048 that is ~22 segments of
//     96 frames against one 2048-frame walk per channel on 128 warps.
//   * Phase one computes, over the whole grid, the part that needs no
//     recurrence: |X|^2 and the demod value of every element (2 Re, the CW
//     beat from the uint32 DDS, the NFM discriminator with atan2f against the
//     previous frame) into two (F, M) scratch planes that the walk reads. A
//     thread takes four neighbouring channels of kFrames consecutive frames:
//     16-byte loads of the planes and stores of the scratch, the previous
//     frame of the NFM discriminator the thread's own last frame after the
//     first (scalar where M % 4 != 0 or a pointer is not 16-byte aligned).
//     A grid barrier (cooperative launch, all blocks resident) separates the
//     phases.
//   * agc = kAgcOff is the demod-only form (the hang route): audio before
//     gain, carry rows 4 and 5 passed through. K4 takes kAgcOff or
//     kAgcApply; kAgcEmitEnv is K5's alone (K4 has no env output).
//   * Bound: device-memory bytes. Planes in (8 B per element), audio out
//     (4 B) and waterfall out: ~101 MB at M = 4096, F = 2048, ~30 us at
//     3.35 TB/s. The scratch round trip adds 16 B per element, and the
//     walk's passes read it again.

#include "channelizer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // __launch_bounds__: 85 registers a thread at most
constexpr int kFrames = 1;     // phase one's frames per thread

// The demod values and |X|^2 of channel c (a column of four when vec) over
// frames [f0, f1), the previous frame of the NFM discriminator carried.
__device__ __forceinline__ void phase_one_item(const float* __restrict__ yr,
                                               const float* __restrict__ yi,
                                               const rf::DemodArgs& a, int c, int f0, int f1,
                                               bool vec, bool nfm) {
  const int M = a.M;
  if (vec) {
    float4 pr, pi;
    if (f0 > 0) {
      pr = __ldg(reinterpret_cast<const float4*>(yr + static_cast<long long>(f0 - 1) * M + c));
      pi = __ldg(reinterpret_cast<const float4*>(yi + static_cast<long long>(f0 - 1) * M + c));
    } else {
      pr = make_float4(a.st_in[2 * M + c], a.st_in[2 * M + c + 1], a.st_in[2 * M + c + 2],
                       a.st_in[2 * M + c + 3]);
      pi = make_float4(a.st_in[3 * M + c], a.st_in[3 * M + c + 1], a.st_in[3 * M + c + 2],
                       a.st_in[3 * M + c + 3]);
    }
    float4 xr[kFrames], xi[kFrames];
#pragma unroll
    for (int u = 0; u < kFrames; ++u) {
      if (f0 + u < f1) {
        const long long i = static_cast<long long>(f0 + u) * M + c;
        xr[u] = __ldg(reinterpret_cast<const float4*>(yr + i));
        xi[u] = __ldg(reinterpret_cast<const float4*>(yi + i));
      }
    }
#pragma unroll
    for (int u = 0; u < kFrames; ++u) {
      const int f = f0 + u;
      if (f >= f1) break;
      const long long i = static_cast<long long>(f) * M + c;
      const float4 x = xr[u], y = xi[u];
      float4 v, p;
      v.x = rf::demod_value(a, c, f, x.x, y.x, pr.x, pi.x);
      v.y = rf::demod_value(a, c + 1, f, x.y, y.y, pr.y, pi.y);
      v.z = rf::demod_value(a, c + 2, f, x.z, y.z, pr.z, pi.z);
      v.w = rf::demod_value(a, c + 3, f, x.w, y.w, pr.w, pi.w);
      p.x = x.x * x.x + y.x * y.x;
      p.y = x.y * x.y + y.y * y.y;
      p.z = x.z * x.z + y.z * y.z;
      p.w = x.w * x.w + y.w * y.w;
      *reinterpret_cast<float4*>(a.v + i) = v;
      *reinterpret_cast<float4*>(a.p + i) = p;
      if (nfm && f == a.F - 1) {
        *reinterpret_cast<float4*>(a.st_out + 2 * M + c) = x;
        *reinterpret_cast<float4*>(a.st_out + 3 * M + c) = y;
      }
      pr = x;
      pi = y;
    }
    return;
  }
  float pr = f0 > 0 ? yr[static_cast<long long>(f0 - 1) * M + c] : a.st_in[2 * M + c];
  float pi = f0 > 0 ? yi[static_cast<long long>(f0 - 1) * M + c] : a.st_in[3 * M + c];
  for (int f = f0; f < f1; ++f) {
    const long long i = static_cast<long long>(f) * M + c;
    const float xr = yr[i], xi = yi[i];
    a.v[i] = rf::demod_value(a, c, f, xr, xi, pr, pi);
    a.p[i] = xr * xr + xi * xi;
    if (nfm && f == a.F - 1) {
      a.st_out[2 * M + c] = xr;
      a.st_out[3 * M + c] = xi;
    }
    pr = xr;
    pi = xi;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
demod_agc_kernel(const float* __restrict__ yr, const float* __restrict__ yi, rf::DemodArgs a,
                 int vec) {
  const bool nfm = rf::enabled(a.en, rf::kNFM);
  const int width = vec ? 4 : 1;  // channels a thread takes
  const int groups = a.M / width;
  const int runs = (a.F + kFrames - 1) / kFrames;
  const long long n = static_cast<long long>(runs) * groups;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int run = static_cast<int>(i / groups);
    const int c = static_cast<int>(i - static_cast<long long>(run) * groups) * width;
    const int f0 = run * kFrames;
    phase_one_item(yr, yi, a, c, f0, f0 + kFrames < a.F ? f0 + kFrames : a.F, vec, nfm);
  }
  rf::grid_barrier(a.barrier);
  rf::agc_walk_all(a, a.barrier + 1);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The grid: phase one's work in whole blocks, capped by residency.
cudaError_t launch_grid(int M, int F, bool vec, int* grid) {
  int resident = 0;
  const cudaError_t err = rf::resident_blocks<demod_agc_kernel>(kThreads, 0, &resident);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((F + kFrames - 1) / kFrames) * (vec ? M / 4 : M);
  const long long work = (items + kThreads - 1) / kThreads;
  *grid = static_cast<int>(work < resident ? (work < 1 ? 1 : work) : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch's thread count (grid times block) at (M, F), for the walk's
// plan (kernels/walk_plan.py); the grid of 16-byte phase one, which every
// launch from FusedDemodAgc takes at M % 4 == 0. Returns the CUDA error.
int rf_demod_agc_threads(int M, int F, int* threads) {
  int grid = 0;
  const cudaError_t err = launch_grid(M, F, M % 4 == 0, &grid);
  *threads = grid * kThreads;
  return static_cast<int>(err);
}

// Returns the CUDA error of the launch (0 = launched). barrier:
// 1 + rf::kWalkCounters zeroed words. S: the walk's time segments, seg its
// (4, S, M) summaries (null when S = 1).
int rf_demod_agc(const float* yr, const float* yi, const int* mode, const int* cw_word,
                 const int* cw_acc, const float* rel, const float* al, const float* tgt,
                 const float* mg, const float* st_in, float* audio, float* wf, float* st_out,
                 float* v, float* p, unsigned int* barrier, int M, int F, int en, int wf_avg,
                 int agc, float dev_scale, float cw_scale, int S, float* seg, void* stream) {
  if (!rf::walk_plan_ok(F, S, wf_avg) || (S > 1 && seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rf::DemodArgs a{mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, audio, wf, st_out, v, p,
                  barrier, nullptr, M, F, en, wf_avg, agc, dev_scale, cw_scale, S, seg};
  int vec = M % 4 == 0 && aligned16(yr) && aligned16(yi) && aligned16(v) && aligned16(p) &&
            aligned16(st_in) && aligned16(st_out);
  int grid = 0;
  cudaError_t err = launch_grid(M, F, vec, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&yr, &yi, &a, &vec};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(demod_agc_kernel), dim3(grid),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
