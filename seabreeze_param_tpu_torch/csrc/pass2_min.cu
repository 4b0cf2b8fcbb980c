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
// * The two-extremum form (sbz_pass2_min_two) stages a second strip, of
//   Mmax (-BIG beyond the field), beside the first, so its staged build
//   stops at a narrower radius (MAX_STAGED_K2 = 93, exported by
//   sbz_pass2_min_two_limits); wider k takes the pruned routine with its
//   second channel.  Its early exit rests on po >= 0, which this form
//   exists to drop, so that build runs every tap whatever the row flags.
//   A tap is min(po * Mmin, po * Mmax), each product rounded, then the
//   add: the plain version's three torch ops.
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

// The widest k of the two-extremum form's staged build.
extern "C" int sbz_pass2_min_two_limits(int* max_staged_k) {
  *max_staged_k = MAX_STAGED_K2;
  return 0;
}

// The two-extremum form: mmax (h+2k, w) beside mmin, -BIG where the window
// holds no coast cell.  No row flags: every tap, at every k.
extern "C" int sbz_pass2_min_two(const float* mmin, const float* mmax,
                                 const float* sdphi2, const float* po,
                                 float* out, int h, int w, int k,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (k > MAX_STAGED_K2)
    return (int)sbz_pruned::launch_pass2_pruned_two(mmin, mmax, sdphi2, po,
                                                    out, h, w, k, s);
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0 &&
                   (uintptr_t)mmax % 16 == 0;
  return vec ? launch<true, true>(mmin, mmax, sdphi2, po, out, h, w, k, s)
             : launch<false, true>(mmin, mmax, sdphi2, po, out, h, w, k, s);
}
