// The options of the wide-radius pass 2 (the port's csrc/pass2_pruned.cuh,
// which has the defaults below as constants), built as kernel B2 at every
// radius k, to be timed side by side (tools/compare_designs.py --only B2):
//   SBZ_PRUNED_CPL     columns a lane (2)
//   SBZ_PRUNED_WARPS   warps (output rows) a block (4)
//   SBZ_PRUNED_GROUP   steps of j between two votes of the early exit (8)
//   SBZ_PRUNED_EXIT    0: no early exit, every tap (1)
//   SBZ_PRUNED_SHFL    0: each tap loads its table entries instead of
//                      taking them by shuffle from a lane that loaded 32
//                      steps' entries at once (1)
//   SBZ_PRUNED_CLOCKS  1: each warp adds its time and taps to counters,
//                      read by sbz_pass2_min_clocks (0)
// The exported functions are kernel B2's (csrc/pass2_min.cu), with the
// routine at every k.
#include <cuda_runtime.h>
#include <stddef.h>

namespace sbz_pruned {
namespace {

constexpr float BIG = 1.0e30f;
#ifndef SBZ_PRUNED_CPL
#define SBZ_PRUNED_CPL 2
#endif
#ifndef SBZ_PRUNED_WARPS
#define SBZ_PRUNED_WARPS 4
#endif
#ifndef SBZ_PRUNED_GROUP
#define SBZ_PRUNED_GROUP 8
#endif
// 0: no early exit (every tap)
#ifndef SBZ_PRUNED_EXIT
#define SBZ_PRUNED_EXIT 1
#endif
// 1: a lane loads the table entries of 32 steps and the taps take them
// by shuffle; 0: every tap loads its own
#ifndef SBZ_PRUNED_SHFL
#define SBZ_PRUNED_SHFL 1
#endif
// 1: each warp adds its time and taps to counters
#ifndef SBZ_PRUNED_CLOCKS
#define SBZ_PRUNED_CLOCKS 0
#endif
constexpr int CPL = SBZ_PRUNED_CPL;      // columns a lane
constexpr int BAND = 32 * CPL;           // columns a warp
constexpr int GROUP = SBZ_PRUNED_GROUP;  // steps of j between two votes
constexpr int WARPS = SBZ_PRUNED_WARPS;  // rows a block
constexpr int NT = 32 * WARPS;
static_assert(32 % GROUP == 0, "a group's steps lie in one chunk of 32");

#if SBZ_PRUNED_CLOCKS
// the warps' summed nanoseconds, taps and count, the first start and the
// last end (%globaltimer)
__device__ unsigned long long clocks[5] = {0, 0, 0, ~0ull, 0};
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

__device__ __forceinline__ float candidate(float t, float q, float lo) {
  const float c = __fadd_rn(t, __fmul_rn(q, lo));
  return lo > 0.5f * BIG ? BIG : c;
}

// mmin (h+2k, w); sdphi2, po (h, 2k+1); row_mono (h) or null: no row is
// taken to have the property (every tap); coast_rows (nseg, h+2k) or null.
__global__ void __launch_bounds__(NT)
pass2_pruned_kernel(const float* __restrict__ mmin,
                    const float* __restrict__ sdphi2,
                    const float* __restrict__ po,
                    const unsigned char* __restrict__ row_mono,
                    const unsigned char* __restrict__ coast_rows, int nseg,
                    float* __restrict__ out, int h, int w, int k) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (y >= h) return;                    // the whole warp
#if SBZ_PRUNED_CLOCKS
  const unsigned long long t0 = now_ns();
  unsigned long long taps = 0;
#endif
  const int nwin = 2 * k + 1, x0 = blockIdx.x * BAND + lane;
  bool xin[CPL];
  float acc[CPL];
  const float* m[CPL];                   // the centre row, column clamped
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    xin[c] = x0 + 32 * c < w;
    acc[c] = BIG;
    m[c] = mmin + (size_t)(y + k) * w + min(x0 + 32 * c, w - 1);
  }
  bool go = true;
  if (coast_rows != nullptr) {
    bool any = false;
    for (int s = 0; s < nseg; ++s) {
      const unsigned char* f = coast_rows + (size_t)s * (h + 2 * k) + y;
      for (int i = lane; i < nwin; i += 32) any |= f[i] != 0;
    }
    go = __any_sync(~0u, any);
  }
  if (go) {
    const float* tp = sdphi2 + (size_t)y * nwin + k;   // centre tap
    const float* tq = po + (size_t)y * nwin + k;
    const bool mono =
        SBZ_PRUNED_EXIT && row_mono != nullptr && row_mono[y] != 0;
#if SBZ_PRUNED_SHFL
    float tm = 0.0f, tpl = 0.0f, qm = 0.0f, qpl = 0.0f;
#endif
    // steps j .. j+GROUP-1 each side, past k clamped to k: a tap taken
    // twice leaves the minimum as it is, so every load of a group is
    // issued before the first is used, with no branch between them
    for (int j = 0; j <= k; j += GROUP) {
      float t[2 * GROUP], q[2 * GROUP], v[2 * GROUP][CPL];
#if SBZ_PRUNED_SHFL
      // lane l holds the entries of step j0 + l, j0 = j rounded down to 32
      if ((j & 31) == 0) {
        const int d = min(j + lane, k);
        tm = __ldg(tp - d), tpl = __ldg(tp + d);
        qm = __ldg(tq - d), qpl = __ldg(tq + d);
      }
#endif
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int d = min(j + g, k);
#if SBZ_PRUNED_SHFL
        const int src = (j + g) & 31;
        t[2 * g] = __shfl_sync(~0u, tm, src);
        q[2 * g] = __shfl_sync(~0u, qm, src);
        t[2 * g + 1] = __shfl_sync(~0u, tpl, src);
        q[2 * g + 1] = __shfl_sync(~0u, qpl, src);
#else
        t[2 * g] = __ldg(tp - d);
        q[2 * g] = __ldg(tq - d);
        t[2 * g + 1] = __ldg(tp + d);
        q[2 * g + 1] = __ldg(tq + d);
#endif
        const ptrdiff_t off = (ptrdiff_t)d * w;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          v[2 * g][c] = __ldg(m[c] - off);
          v[2 * g + 1][c] = __ldg(m[c] + off);
        }
      }
      const int nj = j + GROUP;          // the nearest taps still to visit
      const bool vote = mono && nj <= k;
      const float bound =
          vote ? fminf(__ldg(tp - nj), __ldg(tp + nj)) : 0.0f;
#if SBZ_PRUNED_CLOCKS
      taps += 2 * GROUP;
#endif
#pragma unroll
      for (int i = 0; i < 2 * GROUP; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          acc[c] = fminf(acc[c], candidate(t[i], q[i], v[i][c]));
      if (vote) {
        bool need = false;
#pragma unroll
        for (int c = 0; c < CPL; ++c) need |= xin[c] && acc[c] > bound;
        if (!__any_sync(~0u, need)) break;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (xin[c]) out[(size_t)y * w + x0 + 32 * c] = acc[c];
#if SBZ_PRUNED_CLOCKS
  if (lane == 0) {
    const unsigned long long t1 = now_ns();
    atomicAdd(&clocks[0], t1 - t0);
    atomicAdd(&clocks[1], taps);
    atomicAdd(&clocks[2], 1ull);
    atomicMin(&clocks[3], t0);
    atomicMax(&clocks[4], t1);
  }
#endif
}

cudaError_t launch_pass2_pruned(const float* mmin, const float* sdphi2,
                                const float* po,
                                const unsigned char* row_mono,
                                const unsigned char* coast_rows, int nseg,
                                float* out, int h, int w, int k,
                                cudaStream_t stream) {
  const dim3 grid((w + BAND - 1) / BAND, (h + WARPS - 1) / WARPS);
  pass2_pruned_kernel<<<grid, NT, 0, stream>>>(mmin, sdphi2, po, row_mono,
                                               coast_rows, nseg, out, h, w,
                                               k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sbz_pruned

extern "C" int sbz_pass2_min_layout(int* cols_per_lane, int* group) {
  *cols_per_lane = sbz_pruned::CPL;
  *group = sbz_pruned::GROUP;
  return 0;
}

#if SBZ_PRUNED_CLOCKS
// The counters since the last read: the warps' summed ns, taps, warps,
// first start and last end; reading zeroes them.
extern "C" int sbz_pass2_min_clocks(unsigned long long* host) {
  const unsigned long long zero[5] = {0, 0, 0, ~0ull, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(host, sbz_pruned::clocks, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(sbz_pruned::clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

extern "C" int sbz_pass2_min(const float* mmin, const float* sdphi2,
                             const float* po, const unsigned char* row_mono,
                             float* out, int h, int w, int k, void* stream) {
  if (k < 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  return (int)sbz_pruned::launch_pass2_pruned(
      mmin, sdphi2, po, row_mono, nullptr, 0, out, h, w, k,
      (cudaStream_t)stream);
}
