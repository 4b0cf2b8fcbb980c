// Kernel B2: pass 2 of the separable coast-distance minimum, for Hopper.
//
// Replaces seabreeze_param_tpu/ops/pallas/distance_kernel.py::pass2_min_pallas
// (body _pass2_kernel), in both of its forms.  Single-extremum:
//
//   amin[y, x] = min over di in [0, 2k] of
//                sdphi2[y, di] + po[y, di] * Mmin[y + di, x],
//
// a candidate being BIG where Mmin is BIG (a row window with no coast cell).
// Two-extremum (_pass2_kernel with need_max, for tables whose po may be
// negative, where the window's minimum may sit at its largest sdlam2):
//
//   amin[y, x] = min over di of sdphi2[y, di] +
//                min(po[y, di] * Mmin[y + di, x], po[y, di] * Mmax[y + di, x]),
//
// BIG where Mmin is BIG.  Plain version of both:
// seabreeze_param_tpu_torch/ops/distance.py::pass2_min (Mmax=).
//
// What bounds it on an H100: device memory, by the bytes it must move (Mmin
// in, amin out: 8.45 MB at 0.25 deg, 52.75 MB at 0.1 deg).  Its arithmetic
// is small on real data: ~95% of the output is BIG (no coast within k rows
// and columns), and a tile whose strip holds no coast source skips it.
// What held the first design back at 0.25 deg was the latency of its strip
// loads: each thread loaded its eleven strip values one after another,
// each waiting for device memory before the next was asked for.  A
// register sliding window over 64-row tiles (tools/designs/
// pass2_min_window.cu) is slower still on this data (PERF.md): with the
// taps few, what counts is the bytes in flight, and a thread streaming
// its rows keeps fewer in flight than a block that issues every copy of
// its strip at once.
//
// Design: one block per (TH x TW) = (16 x 128) tile, 128 x 4 threads.
// * Every strip load is in flight at once: each thread issues all of its
//   cp.async copies of the (TH+2k) x TW Mmin strip (16 bytes each where the
//   rows allow, else 4), then waits once.  Beyond the field the strip holds
//   BIG.  The tile's (sdphi2, po) rows are staged beside it as float2, so a
//   tap costs two shared loads, one of them a warp broadcast.
// * A block whose strip holds no source (every Mmin >= BIG/2) writes BIG
//   and skips the tap loop (__syncthreads_or), as _pass2_kernel does.
// * The multiply and the add are rounded separately (__fmul_rn, __fadd_rn):
//   nvcc would otherwise contract them into an FMA, and the result is then
//   bit-equal to the plain version, which runs them as two torch ops.
// * The strip grows with k and outgrows a block's shared memory past
//   MAX_STAGED_K (175; 0.5 km grids have k = 310).  Wider k takes the
//   unstaged build, the pass-2 routine of csrc/pass2_pruned.cuh: one warp
//   per output row and band of columns, the taps centre-out with an exact
//   early exit where the caller gives the rows of sdphi2 that allow it
//   (row_mono).  The unstaged build before it (every tap of every cell
//   through L1) is kept in tools/designs/pass2_min_unstaged_l1.cu, the
//   routine's
//   options in tools/designs/pass2_pruned_variants.cu, each timed beside it
//   (tools/compare_designs.py --only B2).  The library exports the
//   threshold (sbz_pass2_min_limits) and the routine's layout
//   (sbz_pass2_min_layout).
// * The two-extremum form (sbz_pass2_min_two) reads one extremum a tap
//   where it can.  Its precondition, which pass 1's extrema meet
//   (ops/distance.py::pass1_extrema(need_max=True)): where Mmin <= BIG/2
//   (a window with coast), -BIG/2 <= Mmin <= Mmax <= BIG/2; where Mmin >
//   BIG/2 (none), |Mmax| > BIG/2 (pass 1 gives -BIG; a copy of Mmin gives
//   BIG).  A rounded multiply by a fixed po is monotone, so min(po * Mmin,
//   po * Mmax) is po * Mmin where po >= 0 (-0.0 included: the products are
//   then zeros, which the add to sdphi2 leaves equal) and po * Mmax where
//   po < 0; the pruned build's tap reads that extremum alone, its
//   candidate BIG where the value read lies outside [-BIG/2, BIG/2].
//   po[y, di] is one value for a warp's output row, so the choice costs
//   no divergence.  The result is the plain version's bit for bit (its
//   three torch ops, each rounded).
//   - Its staged build (k <= MAX_STAGED_K2 = 93, exported by
//     sbz_pass2_min_two_limits) stages a second strip, of Mmax (-BIG
//     beyond the field), beside the first and takes the plain version's
//     min of both products a tap: a load chosen by the table entry's sign
//     waits for that entry's own shared load, a chain one block an SM
//     cannot hide (PERF.md).  The route stays at that limit: on po drawn
//     from [-1, 1] the pruned build loses to the staged one at every k up
//     to it (tools/compare_designs.py --only B2two; times in PERF.md).
//   - Past it, the pruned routine of pass2_pruned.cuh with an exact early
//     exit for po of either sign.  Two small launches first build its
//     bound: two_row_extrema reduces each padded row r to E_lo[r], its
//     least valid Mmin, and E_hi[r], its greatest valid Mmax; two_bound
//     gives each output row the least candidate a tap could give,
//     B[y, di] = sdphi2 + po * E (E = E_lo[y+di] where po >= 0, E_hi[y+di]
//     where po < 0, each op rounded; BIG where that row holds no valid
//     value), and its suffix minimum over steps at the routine's votes,
//     bound_tab[y, g] = min over |di - k| >= g * GROUP of B[y, di] (at
//     most BIG).  Every candidate of tap di is >= B[y, di] because
//     __fmul_rn and __fadd_rn are monotone and the value read lies between
//     E and the sign's side; so a warp may leave once no lane's minimum is
//     above the entry of the nearest step still to visit, and a row whose
//     bound_tab[y, 0] is BIG takes no tap.  With po >= 0 and Mmin >= 0 the
//     bound is never below the single form's (the least sdphi2 still to
//     come), so on a grid's tables it exits as early.  Both tables sit in
//     device scratch the wrapper allocates (sbz_pass2_min_two_scratch);
//     the host waits on nothing.  The builds before this redesign (both
//     strips staged, both extrema read a tap, every tap past the staged
//     build) are kept in tools/designs/pass2_min_two_first.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pass2_pruned.cuh"

namespace {

constexpr int TW = 128;  // tile columns = threads along x
constexpr int TY = 4;    // threads along y
constexpr int NT = TW * TY;
constexpr int TH = 16;   // tile rows; each thread owns TH / TY of them
constexpr float BIG = 1.0e30f;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold

// the staged build's shared memory: the strip (two strips, Mmin and Mmax,
// in the two-extremum form) and the tile's table rows
constexpr size_t staged_smem(int k, bool two = false) {
  return sizeof(float) * (two ? 2 : 1) * (size_t)(TH + 2 * k) * TW +
         sizeof(float) * 2 * (size_t)TH * (2 * k + 1);
}
constexpr int max_staged_k(bool two) {
  int k = 0;
  while (staged_smem(k + 1, two) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_STAGED_K = max_staged_k(false);
constexpr int MAX_STAGED_K2 = max_staged_k(true);

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// VEC: w % 4 == 0 and 16-byte aligned rows, so the strip is copied in
// 16-byte pieces.  TWO: the two-extremum form, mmax staged beside mmin.
template <bool VEC, bool TWO>
__global__ void __launch_bounds__(NT)
pass2_min_kernel(const float* __restrict__ mmin,
                 const float* __restrict__ mmax,
                 const float* __restrict__ sdphi2,
                 const float* __restrict__ po, float* __restrict__ out,
                 int h, int w, int k) {
  extern __shared__ float4 smem4[];
  const int nwin = 2 * k + 1;
  const int rows = TH + 2 * k;
  float* s_m = reinterpret_cast<float*>(smem4);           // rows x TW strip
  float* s_x = s_m + rows * TW;                    // TWO: the Mmax strip
  float2* s_t = reinterpret_cast<float2*>(s_x + (TWO ? rows * TW : 0));

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int mrows = h + 2 * k;

  // the strip(s): every copy issued, then one wait
  constexpr int PIECE = VEC ? 4 : 1;          // floats per copy
  constexpr int PER_ROW = TW / PIECE;
  for (int i = tid; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * PIECE;
    const int gy = y0 + r, gx = x0 + c;
    float* dst = s_m + r * TW + c;
    if (gy < mrows && gx + PIECE <= w) {
      cp_async(dst, mmin + (size_t)gy * w + gx, PIECE * 4);
      if (TWO) cp_async(dst + rows * TW, mmax + (size_t)gy * w + gx,
                        PIECE * 4);
    } else {
#pragma unroll
      for (int u = 0; u < PIECE; ++u) {
        const bool in = gy < mrows && gx + u < w;
        dst[u] = in ? mmin[(size_t)gy * w + gx + u] : BIG;
        if (TWO) dst[rows * TW + u] = in ? mmax[(size_t)gy * w + gx + u]
                                         : -BIG;
      }
    }
  }
  for (int i = tid; i < TH * nwin; i += NT) {
    const size_t g = (size_t)y0 * nwin + i;
    s_t[i] = y0 + i / nwin < h ? make_float2(sdphi2[g], po[g])
                               : make_float2(BIG, 0.0f);
  }
  cp_async_wait_all();
  __syncthreads();

  bool any_src = false;
  for (int i = tid; i < rows * TW; i += NT) any_src |= s_m[i] < 0.5f * BIG;
  const bool compute = __syncthreads_or(any_src);

  const int tx = threadIdx.x, x = x0 + tx;
  for (int r = threadIdx.y; r < TH; r += TY) {
    const int gy = y0 + r;
    if (gy >= h || x >= w) continue;
    float amin = BIG;
    if (compute) {
      const float2* t = s_t + r * nwin;
      const float* m = s_m + r * TW + tx;
#pragma unroll 4
      for (int di = 0; di < nwin; ++di) {
        const float lo = m[di * TW];
        const float2 tap = t[di];
        float prod = __fmul_rn(tap.y, lo);
        if (TWO) prod = fminf(prod, __fmul_rn(tap.y, m[rows * TW + di * TW]));
        float cand = __fadd_rn(tap.x, prod);
        cand = lo > 0.5f * BIG ? BIG : cand;
        amin = fminf(amin, cand);
      }
    }
    out[(size_t)gy * w + x] = amin;
  }
}

// The two-extremum form's exit tables (its pruned build), in the scratch
// of sbz_pass2_min_two_scratch: ext (2, h+2k), each padded row's least
// valid Mmin and greatest valid Mmax (BIG / -BIG where it holds none;
// valid: within [-BIG/2, BIG/2], the taps' own test), then bound_tab
// (h, k/GROUP + 1).
constexpr int EXT_NT = 256;      // threads a padded row
constexpr int BOUND_WARPS = 4;   // output rows a block of two_bound

__global__ void __launch_bounds__(EXT_NT)
two_row_extrema(const float* __restrict__ mmin,
                const float* __restrict__ mmax, float* __restrict__ ext,
                int mrows, int w) {
  const int r = blockIdx.x;
  const float* a = mmin + (size_t)r * w;
  const float* b = mmax + (size_t)r * w;
  float lo = BIG, hi = -BIG;
#pragma unroll 4
  for (int x = threadIdx.x; x < w; x += EXT_NT) {
    const float u = __ldg(a + x), v = __ldg(b + x);
    if (fabsf(u) <= 0.5f * BIG) lo = fminf(lo, u);
    if (fabsf(v) <= 0.5f * BIG) hi = fmaxf(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(~0u, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(~0u, hi, o));
  }
  __shared__ float s_lo[EXT_NT / 32], s_hi[EXT_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_lo[warp] = lo, s_hi[warp] = hi;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < EXT_NT / 32; ++i)
      lo = fminf(lo, s_lo[i]), hi = fmaxf(hi, s_hi[i]);
    ext[r] = lo;
    ext[mrows + r] = hi;
  }
}

// The least candidate tap (t, q) can give on a padded row whose extrema
// are (lo, hi): the rounded t + q * lo where q >= 0, t + q * hi where q <
// 0, BIG where that extremum is not valid (the row holds none); at most
// BIG.
__device__ __forceinline__ float tap_bound(float t, float q, float lo,
                                           float hi) {
  const float e = q >= 0.0f ? lo : hi;
  return fabsf(e) <= 0.5f * BIG ? fminf(__fadd_rn(t, __fmul_rn(q, e)), BIG)
                                : BIG;
}

// One warp an output row: bound_tab[y, g] = min over steps s >= g * GROUP
// of min(B[y, k-s], B[y, k+s]) (GROUP the routine's steps between two
// votes), a group a lane, 32 groups at a time from the far end, a suffix
// minimum across the lanes carried to the next 32.
__global__ void __launch_bounds__(32 * BOUND_WARPS)
two_bound(const float* __restrict__ sdphi2, const float* __restrict__ po,
          const float* __restrict__ ext, float* __restrict__ bound_tab,
          int h, int k) {
  constexpr int GROUP = sbz_pruned::GROUP;
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * BOUND_WARPS + (threadIdx.x >> 5);
  if (y >= h) return;                    // the whole warp
  const int ng = k / GROUP + 1;
  const size_t c = (size_t)y * (2 * k + 1) + k;   // the centre tap
  const float* t = sdphi2 + c;
  const float* q = po + c;
  const float* lo = ext + y + k;         // E_lo of the centre tap's row
  const float* hi = lo + h + 2 * k;
  float* out = bound_tab + (size_t)y * ng;
  float carry = BIG;
  for (int g0 = (ng - 1) & ~31; g0 >= 0; g0 -= 32) {
    const int g = g0 + lane;
    float b = BIG;
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int s = g * GROUP + u;
      if (s <= k)
        b = fminf(b, fminf(tap_bound(__ldg(t - s), __ldg(q - s),
                                     __ldg(lo - s), __ldg(hi - s)),
                           tap_bound(__ldg(t + s), __ldg(q + s),
                                     __ldg(lo + s), __ldg(hi + s))));
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(~0u, b, o);
      if (lane + o < 32) b = fminf(b, u);
    }
    b = fminf(b, carry);
    if (g < ng) out[g] = b;
    carry = __shfl_sync(~0u, b, 0);
  }
}

template <bool VEC, bool TWO>
int launch(const float* mmin, const float* mmax, const float* sdphi2,
           const float* po, float* out, int h, int w, int k,
           cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const dim3 block(TW, TY);
  const size_t smem = staged_smem(k, TWO);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pass2_min_kernel<VEC, TWO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  pass2_min_kernel<VEC, TWO><<<grid, block, smem, stream>>>(
      mmin, mmax, sdphi2, po, out, h, w, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest k of the staged build; wider k takes the unstaged build.
extern "C" int sbz_pass2_min_limits(int* max_staged_k) {
  *max_staged_k = MAX_STAGED_K;
  return 0;
}

// The unstaged build's layout: columns a lane (a warp owns 32 times as
// many) and steps of j between two votes of its early exit.
extern "C" int sbz_pass2_min_layout(int* cols_per_lane, int* group) {
  *cols_per_lane = sbz_pruned::CPL;
  *group = sbz_pruned::GROUP;
  return 0;
}

// row_mono (h bytes): nonzero where the row of sdphi2 has the monotone
// property (csrc/pass2_pruned.cuh), which lets the unstaged build stop
// early; null: every tap.  The staged build runs every tap either way.
extern "C" int sbz_pass2_min(const float* mmin, const float* sdphi2,
                             const float* po, const unsigned char* row_mono,
                             float* out, int h, int w, int k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (k > MAX_STAGED_K)
    return (int)sbz_pruned::launch_pass2_pruned(mmin, sdphi2, po, row_mono,
                                                nullptr, 0, out, h, w, k, s);
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0;
  return vec ? launch<true, false>(mmin, nullptr, sdphi2, po, out, h, w, k, s)
             : launch<false, false>(mmin, nullptr, sdphi2, po, out, h, w, k,
                                    s);
}

// The widest k of the two-extremum form's staged build; wider k takes the
// pruned build with its exit tables.
extern "C" int sbz_pass2_min_two_limits(int* max_staged_k) {
  *max_staged_k = MAX_STAGED_K2;
  return 0;
}

// The float32 scratch sbz_pass2_min_two needs at (h, w, k): its exit
// tables past the staged build, none up to it.
extern "C" int sbz_pass2_min_two_scratch(int h, int w, int k,
                                         long long* floats) {
  const long long groups = k / sbz_pruned::GROUP + 1;
  *floats = k > MAX_STAGED_K2 ? 2LL * (h + 2LL * k) + h * groups : 0;
  return 0;
}

// The two-extremum form: mmax (h+2k, w) beside mmin, under the precondition
// above.  No row flags.  scratch: sbz_pass2_min_two_scratch's floats (may
// be null where it asks for none).
extern "C" int sbz_pass2_min_two(const float* mmin, const float* mmax,
                                 const float* sdphi2, const float* po,
                                 float* out, int h, int w, int k,
                                 float* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (k > MAX_STAGED_K2) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int mrows = h + 2 * k;
    float* tab = scratch + 2 * (size_t)mrows;
    two_row_extrema<<<mrows, EXT_NT, 0, s>>>(mmin, mmax, scratch, mrows, w);
    two_bound<<<(h + BOUND_WARPS - 1) / BOUND_WARPS, 32 * BOUND_WARPS, 0,
                s>>>(sdphi2, po, scratch, tab, h, k);
    return (int)sbz_pruned::launch_pass2_pruned_two(mmin, mmax, sdphi2, po,
                                                    tab, out, h, w, k, s);
  }
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0 &&
                   (uintptr_t)mmax % 16 == 0;
  return vec ? launch<true, true>(mmin, mmax, sdphi2, po, out, h, w, k, s)
             : launch<false, true>(mmin, mmax, sdphi2, po, out, h, w, k, s);
}
