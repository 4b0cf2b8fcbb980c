// The pass-2 routine of the distance kernels' wide-radius builds, for
// Hopper: kernel B2's unstaged build (csrc/pass2_min.cu, k > 175) and the
// second launch of kernel B3's large build (csrc/min_haversine.cu,
// k > 354).  Both replace seabreeze_param_tpu/ops/pallas/
// distance_kernel.py's pass 2, single-extremum form:
//
//   amin[y, x] = min over di in [0, 2k] of
//                sdphi2[y, di] + po[y, di] * Mmin[y + di, x],
//
// a candidate being BIG where Mmin > BIG/2.  Plain version:
// seabreeze_param_tpu_torch/ops/distance.py::pass2_min.
//
// Design: one warp owns one output row and a band of 32 * CPL columns,
// CPL a lane (lane l owns band columns l, l + 32, ...); a block is WARPS
// warps on consecutive rows of one band, so their Mmin rows overlap in L1.
// * The taps are visited centre-out: di = k, then k -+ 1, k -+ 2, ..., in
//   groups of GROUP steps.  A tap reads Mmin[y + di, band] coalesced (128
//   bytes a warp and column of a lane) and the row's (sdphi2, po) at one
//   address a warp.  Steps past k are clamped to k (a tap taken twice
//   leaves the minimum as it is) and columns past w to w - 1, so no branch
//   stands between a group's loads.  The table entries of 32 steps are
//   loaded at once, one step a lane (4 coalesced loads), and each tap
//   takes its pair by shuffle: what bounds the routine is the loads a warp
//   issues, and this leaves one a column and tap.
// * An exact early exit.  po >= 0 and Mmin >= 0, so with round-to-nearest
//   a candidate is never below its sdphi2[y, di].  Where the row of sdphi2
//   does not increase from either end of the window to its centre tap
//   (row_mono[y], checked on the host by ops.distance.window_monotone), no
//   tap past k -+ j can give less than min(sdphi2[y, k-j], sdphi2[y, k+j]).
//   After every GROUP steps of j the warp votes, and it leaves once no
//   lane's minimum is above that bound.  The bound depends on the row
//   only, so the vote and the loop are uniform across the warp; lanes past
//   w vote false.  The first group holds the centre tap twice.  The minimum does not depend on the order of its taps,
//   so the result stays bit-equal to the plain version.  At a lat edge the
//   taps out of range hold sdphi2 = BIG, so the bound comes from the valid
//   side.  Taps are few where the coast is near, whatever k is.
// * coast_rows (optional): per padded row and column segment, nonzero where
//   the row holds coast; a warp whose 2k+1 window rows hold none writes BIG
//   without taps (the unflagged routine would run every tap).
// * The multiply and the add are rounded separately (__fmul_rn, __fadd_rn),
//   as the plain version runs them as two torch ops.
// * The two-extremum form (TWO, B2's sbz_pass2_min_two past its staged
//   build) takes sdphi2 + min(po * Mmin, po * Mmax) a tap.  Where the
//   window holds coast, Mmin <= Mmax (pass 1's extrema), and a rounded
//   multiply by a fixed po is monotone, so that minimum is po * Mmin where
//   po >= 0 and po * Mmax where po < 0: a tap reads the one extremum that
//   the sign of its po names.  po[y, di] is one value for the warp (its
//   row), so the choice costs no divergence; the signs of a chunk's 32
//   steps are taken once, as two ballots, so a tap's address waits on no
//   shuffle, and a chunk whose po are all >= 0 (every chunk of a grid's own
//   tables) loads as the single form does.  A candidate is BIG where the
//   value read lies outside [-BIG/2, BIG/2] (an empty window: Mmin BIG,
//   Mmax -BIG, or BIG where Mmax is a copy of Mmin).  Its po may be
//   negative, so the bound of the single form does not hold; the exit
//   takes its bound from bound_tab (h, k/GROUP + 1) instead: bound_tab[y, g]
//   is no more than any candidate of a tap at step g * GROUP or past it,
//   the steps where the votes fall (csrc/pass2_min.cu
//   builds it from each padded row's least valid Mmin and greatest valid
//   Mmax), and BIG at j = 0 where no window of the row holds coast, whose
//   warps take no tap.  Every vote uses it (the entries of a chunk's
//   groups loaded once, a group a lane, and taken by shuffle); the row
//   flags are not read.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Internal linkage: each source that includes this has its own copy.
namespace sbz_pruned {
namespace {

constexpr float BIG = 1.0e30f;
// Each timed against its alternatives (tools/designs/
// pass2_pruned_variants.cu, PERF.md).
constexpr int CPL = 2;                   // columns a lane
constexpr int BAND = 32 * CPL;           // columns a warp
constexpr int GROUP = 8;                 // steps of j between two votes
constexpr int WARPS = 4;                 // rows a block
constexpr int NT = 32 * WARPS;
static_assert(32 % GROUP == 0, "a group's steps lie in one chunk of 32");

__device__ __forceinline__ float candidate(float t, float q, float lo) {
  const float c = __fadd_rn(t, __fmul_rn(q, lo));
  return lo > 0.5f * BIG ? BIG : c;
}

// TWO: v is the extremum the sign of q names
__device__ __forceinline__ float candidate2(float t, float q, float v) {
  const float c = __fadd_rn(t, __fmul_rn(q, v));
  return fabsf(v) > 0.5f * BIG ? BIG : c;
}

// The table entries and taps of the group of steps j .. j+GROUP-1 (past k
// clamped to k), lane l of the chunk holding step j0 + l.  MIXED (TWO,
// where some step of the chunk has po < 0: bit l of negm / negp, each
// side): each tap reads the extremum its sign names, the choice taken
// from the masks, so no load waits for a shuffle; else Mmin alone.
template <bool MIXED>
__device__ __forceinline__ void group_taps(
    float (&t)[2 * GROUP], float (&q)[2 * GROUP], float (&v)[2 * GROUP][CPL],
    const float* (&m)[CPL], const float* (&mx)[CPL], float tm, float tpl,
    float qm, float qpl, unsigned negm, unsigned negp, int j, int k, int w) {
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const int src = (j + g) & 31;
    t[2 * g] = __shfl_sync(~0u, tm, src);
    q[2 * g] = __shfl_sync(~0u, qm, src);
    t[2 * g + 1] = __shfl_sync(~0u, tpl, src);
    q[2 * g + 1] = __shfl_sync(~0u, qpl, src);
    const ptrdiff_t off = (ptrdiff_t)min(j + g, k) * w;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if constexpr (MIXED) {
        v[2 * g][c] = __ldg(((negm >> src) & 1 ? mx[c] : m[c]) - off);
        v[2 * g + 1][c] = __ldg(((negp >> src) & 1 ? mx[c] : m[c]) + off);
      } else {
        v[2 * g][c] = __ldg(m[c] - off);
        v[2 * g + 1][c] = __ldg(m[c] + off);
      }
    }
  }
}

// mmin (h+2k, w); TWO: mmax (h+2k, w) too; sdphi2, po (h, 2k+1); row_mono
// (h) or null: no row is taken to have the property (every tap; TWO never
// reads it); coast_rows (nseg, h+2k) or null; TWO: bound_tab (h, k/GROUP
// + 1), which the single form never reads.
template <bool TWO>
__global__ void __launch_bounds__(NT)
pass2_pruned_kernel(const float* __restrict__ mmin,
                    const float* __restrict__ mmax,
                    const float* __restrict__ sdphi2,
                    const float* __restrict__ po,
                    const unsigned char* __restrict__ row_mono,
                    const unsigned char* __restrict__ coast_rows, int nseg,
                    float* __restrict__ out, int h, int w, int k,
                    const float* __restrict__ bound_tab) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (y >= h) return;                    // the whole warp
  const int nwin = 2 * k + 1, x0 = blockIdx.x * BAND + lane;
  bool xin[CPL];
  float acc[CPL];
  const float* m[CPL];                   // the centre row, column clamped
  const float* mx[CPL];                  // TWO: the same of mmax
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    xin[c] = x0 + 32 * c < w;
    acc[c] = BIG;
    const size_t i = (size_t)(y + k) * w + min(x0 + 32 * c, w - 1);
    m[c] = mmin + i;
    mx[c] = TWO ? mmax + i : m[c];
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
  const float* lb = TWO ? bound_tab + (size_t)y * (k / GROUP + 1) : nullptr;
  if constexpr (TWO) go = __ldg(lb) < BIG;
  if (go) {
    const float* tp = sdphi2 + (size_t)y * nwin + k;   // centre tap
    const float* tq = po + (size_t)y * nwin + k;
    const bool mono = !TWO && row_mono != nullptr && row_mono[y] != 0;
    float tm = 0.0f, tpl = 0.0f, qm = 0.0f, qpl = 0.0f;
    // TWO: the steps of the chunk whose po < 0 (bit l: step j0 + l), each
    // side, and lane l's bound after the chunk's group l (lanes past the
    // chunk's groups hold the last)
    unsigned negm = 0, negp = 0;
    float lnext = 0.0f;
    // steps j .. j+GROUP-1 each side, past k clamped to k: a tap taken
    // twice leaves the minimum as it is, so every load of a group is
    // issued before the first is used, with no branch between them
    for (int j = 0; j <= k; j += GROUP) {
      float t[2 * GROUP], q[2 * GROUP], v[2 * GROUP][CPL];
      // lane l holds the entries of step j0 + l, j0 = j rounded down to 32
      if ((j & 31) == 0) {
        const int d = min(j + lane, k);
        tm = __ldg(tp - d), tpl = __ldg(tp + d);
        qm = __ldg(tq - d), qpl = __ldg(tq + d);
        if constexpr (TWO) {
          negm = __ballot_sync(~0u, !(qm >= 0.0f));
          negp = __ballot_sync(~0u, !(qpl >= 0.0f));
          lnext = __ldg(lb + min(j / GROUP + 1 + lane, k / GROUP));
        }
      }
      if (TWO && (negm | negp))
        group_taps<true>(t, q, v, m, mx, tm, tpl, qm, qpl, negm, negp, j, k,
                         w);
      else
        group_taps<false>(t, q, v, m, mx, tm, tpl, qm, qpl, negm, negp, j, k,
                          w);
      const int nj = j + GROUP;          // the nearest taps still to visit
      bool vote;
      float bound;
      if constexpr (TWO) {
        vote = nj <= k;
        bound = vote ? __shfl_sync(~0u, lnext, (j & 31) / GROUP) : 0.0f;
      } else {
        vote = mono && nj <= k;
        bound = vote ? fminf(__ldg(tp - nj), __ldg(tp + nj)) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 2 * GROUP; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          acc[c] = fminf(acc[c], TWO ? candidate2(t[i], q[i], v[i][c])
                                     : candidate(t[i], q[i], v[i][c]));
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
}

cudaError_t launch_pass2_pruned(const float* mmin, const float* sdphi2,
                                const float* po,
                                const unsigned char* row_mono,
                                const unsigned char* coast_rows, int nseg,
                                float* out, int h, int w, int k,
                                cudaStream_t stream) {
  const dim3 grid((w + BAND - 1) / BAND, (h + WARPS - 1) / WARPS);
  pass2_pruned_kernel<false><<<grid, NT, 0, stream>>>(
      mmin, nullptr, sdphi2, po, row_mono, coast_rows, nseg, out, h, w, k,
      nullptr);
  return cudaGetLastError();
}

// The two-extremum form: the exit's bound from bound_tab (h, k/GROUP + 1),
// no row flags, no coast rows.
inline cudaError_t launch_pass2_pruned_two(const float* mmin,
                                           const float* mmax,
                                           const float* sdphi2,
                                           const float* po,
                                           const float* bound_tab,
                                           float* out, int h, int w, int k,
                                           cudaStream_t stream) {
  const dim3 grid((w + BAND - 1) / BAND, (h + WARPS - 1) / WARPS);
  pass2_pruned_kernel<true><<<grid, NT, 0, stream>>>(
      mmin, mmax, sdphi2, po, nullptr, nullptr, 0, out, h, w, k, bound_tab);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sbz_pruned
