// Kernel B2 as it was before the wide-radius redesign (csrc/pass2_min.cu
// then), kept to be timed beside the port's (tools/compare_designs.py
// --only B2: `l1`).
// Its unstaged build (k > MAX_STAGED_K) reads every tap of every cell
// through L1; the port's now visits the taps centre-out with an early
// exit (csrc/pass2_pruned.cuh, PERF.md §6).

// Kernel B2: pass 2 of the separable coast-distance minimum, for Hopper.
//
// Replaces seabreeze_param_tpu/ops/pallas/distance_kernel.py::pass2_min_pallas
// (body _pass2_kernel), single-extremum form:
//
//   amin[y, x] = min over di in [0, 2k] of
//                sdphi2[y, di] + po[y, di] * Mmin[y + di, x],
//
// a candidate being BIG where Mmin is BIG (a row window with no coast cell).
// Plain version: seabreeze_param_tpu_torch/ops/distance.py::pass2_min.
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
//   unstaged build: the same tiles, each thread reading its column's 2k+1
//   Mmin values through L1 (the rows of a thread's window overlap those of
//   the next row's, and a warp reads 128 contiguous bytes a tap) and the
//   taps' (sdphi2, po) through L1 as well (one address a warp), with four
//   running minima a thread; no tile is skipped.  The library exports the
//   threshold (sbz_pass2_min_limits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;  // tile columns = threads along x
constexpr int TY = 4;    // threads along y
constexpr int NT = TW * TY;
constexpr int TH = 16;   // tile rows; each thread owns TH / TY of them
constexpr float BIG = 1.0e30f;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold

// the staged build's shared memory: the strip and the tile's table rows
constexpr size_t staged_smem(int k) {
  return sizeof(float) * (size_t)(TH + 2 * k) * TW +
         sizeof(float) * 2 * (size_t)TH * (2 * k + 1);
}
constexpr int max_staged_k() {
  int k = 0;
  while (staged_smem(k + 1) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_STAGED_K = max_staged_k();

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
// 16-byte pieces.
template <bool VEC>
__global__ void __launch_bounds__(NT)
pass2_min_kernel(const float* __restrict__ mmin,
                 const float* __restrict__ sdphi2,
                 const float* __restrict__ po, float* __restrict__ out,
                 int h, int w, int k) {
  extern __shared__ float4 smem4[];
  const int nwin = 2 * k + 1;
  const int rows = TH + 2 * k;
  float* s_m = reinterpret_cast<float*>(smem4);           // rows x TW strip
  float2* s_t = reinterpret_cast<float2*>(s_m + rows * TW);  // TH x nwin

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int mrows = h + 2 * k;

  // the strip: every copy issued, then one wait
  constexpr int PIECE = VEC ? 4 : 1;          // floats per copy
  constexpr int PER_ROW = TW / PIECE;
  for (int i = tid; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * PIECE;
    const int gy = y0 + r, gx = x0 + c;
    float* dst = s_m + r * TW + c;
    if (gy < mrows && gx + PIECE <= w) {
      cp_async(dst, mmin + (size_t)gy * w + gx, PIECE * 4);
    } else {
#pragma unroll
      for (int u = 0; u < PIECE; ++u)
        dst[u] = gy < mrows && gx + u < w ? mmin[(size_t)gy * w + gx + u]
                                          : BIG;
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
        float cand = __fadd_rn(tap.x, __fmul_rn(tap.y, lo));
        cand = lo > 0.5f * BIG ? BIG : cand;
        amin = fminf(amin, cand);
      }
    }
    out[(size_t)gy * w + x] = amin;
  }
}

// The unstaged build (k > MAX_STAGED_K): the staged build's tiles and
// threads, every value read through L1.
__global__ void __launch_bounds__(NT)
pass2_min_unstaged(const float* __restrict__ mmin,
                   const float* __restrict__ sdphi2,
                   const float* __restrict__ po, float* __restrict__ out,
                   int h, int w, int k) {
  const int nwin = 2 * k + 1;
  const int x = blockIdx.x * TW + threadIdx.x;
  if (x >= w) return;
  for (int r = threadIdx.y; r < TH; r += TY) {
    const int gy = blockIdx.y * TH + r;
    if (gy >= h) break;
    const float* m = mmin + (size_t)gy * w + x;
    const float* tp = sdphi2 + (size_t)gy * nwin;
    const float* tq = po + (size_t)gy * nwin;
    float acc[4] = {BIG, BIG, BIG, BIG};
    int di = 0;
    for (; di + 4 <= nwin; di += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float lo = __ldg(m + (size_t)(di + u) * w);
        const float cand = __fadd_rn(__ldg(tp + di + u),
                                     __fmul_rn(__ldg(tq + di + u), lo));
        acc[u] = fminf(acc[u], lo > 0.5f * BIG ? BIG : cand);
      }
    }
    for (; di < nwin; ++di) {
      const float lo = __ldg(m + (size_t)di * w);
      const float cand = __fadd_rn(__ldg(tp + di), __fmul_rn(__ldg(tq + di),
                                                              lo));
      acc[0] = fminf(acc[0], lo > 0.5f * BIG ? BIG : cand);
    }
    out[(size_t)gy * w + x] =
        fminf(fminf(acc[0], acc[1]), fminf(acc[2], acc[3]));
  }
}

template <bool VEC>
int launch(const float* mmin, const float* sdphi2, const float* po,
           float* out, int h, int w, int k, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const dim3 block(TW, TY);
  if (k > MAX_STAGED_K) {
    pass2_min_unstaged<<<grid, block, 0, stream>>>(mmin, sdphi2, po, out, h,
                                                   w, k);
    return (int)cudaGetLastError();
  }
  const size_t smem = staged_smem(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pass2_min_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  pass2_min_kernel<VEC><<<grid, block, smem, stream>>>(mmin, sdphi2, po,
                                                       out, h, w, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest k of the staged build; wider k takes the unstaged build.
extern "C" int sbz_pass2_min_limits(int* max_staged_k) {
  *max_staged_k = MAX_STAGED_K;
  return 0;
}

extern "C" int sbz_pass2_min(const float* mmin, const float* sdphi2,
                             const float* po, float* out, int h, int w, int k,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0;
  return vec ? launch<true>(mmin, sdphi2, po, out, h, w, k, s)
             : launch<false>(mmin, sdphi2, po, out, h, w, k, s);
}
