// Kernel B2, register sliding-window design: an alternative to
// seabreeze_param_tpu_torch/csrc/pass2_min.cu with the same C interface
// (sbz_pass2_min), kept so that tools/compare_designs.py can time the two
// side by side.  Same function, bit for bit:
//
//   amin[y, x] = min over di in [0, 2k] of
//                sdphi2[y, di] + po[y, di] * Mmin[y + di, x],
//
// a candidate being BIG where Mmin is BIG.
//
// Design: tall tiles of (TY * R) x 128 outputs, one block each.  Each
// thread owns 4 adjacent columns (one float4) and R consecutive output
// rows, and streams the R + 2k Mmin rows under them from device memory
// straight into registers, DEPTH rows in flight at once: no Mmin strip in
// shared memory.  Mmin row m feeds output rows m - 2k .. m; the thread
// keeps R x 4 running minima in registers.  The tile's (sdphi2, po) rows
// sit interleaved as float2 in shared memory, so one broadcast load serves
// the four columns of a tap.  A warp skips a Mmin row in which none of
// its 128 columns holds a source (every value >= BIG/2): such a row adds
// only BIG candidates.  Roundings as in csrc/pass2_min.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SBZ_WINDOW_R
#define SBZ_WINDOW_R 8
#endif
#ifndef SBZ_WINDOW_TY
#define SBZ_WINDOW_TY 8
#endif
constexpr int R = SBZ_WINDOW_R;    // output rows per thread
constexpr int TY = SBZ_WINDOW_TY;  // threads along y
constexpr int TX = 32;             // threads along x, 4 columns each
constexpr int TW = 4 * TX;         // tile columns
constexpr int TH = R * TY;         // tile rows
#ifndef SBZ_WINDOW_DEPTH
#define SBZ_WINDOW_DEPTH 4
#endif
constexpr int DEPTH = SBZ_WINDOW_DEPTH;  // Mmin rows in flight per thread
constexpr float BIG = 1.0e30f;

template <bool VEC>
__device__ __forceinline__ float4 load_row(const float* __restrict__ mmin,
                                           int gy, int mrows, int x, int w) {
  if (gy >= mrows) return make_float4(BIG, BIG, BIG, BIG);
  const float* p = mmin + (size_t)gy * w + x;
  if (VEC && x + 3 < w) return *reinterpret_cast<const float4*>(p);
  return make_float4(x < w ? p[0] : BIG, x + 1 < w ? p[1] : BIG,
                     x + 2 < w ? p[2] : BIG, x + 3 < w ? p[3] : BIG);
}

__device__ __forceinline__ void tap(float& acc, float2 t, float lo) {
  const float cand = __fadd_rn(t.x, __fmul_rn(t.y, lo));
  acc = fminf(acc, lo > 0.5f * BIG ? BIG : cand);
}

// VEC: w % 4 == 0 and 16-byte aligned rows.
template <bool VEC>
__global__ void __launch_bounds__(TX * TY)
pass2_min_window(const float* __restrict__ mmin,
                 const float* __restrict__ sdphi2,
                 const float* __restrict__ po, float* __restrict__ out,
                 int h, int w, int k) {
  extern __shared__ float2 s_t[];  // TH x nwin (sdphi2, po)
  const int nwin = 2 * k + 1;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int y0 = blockIdx.y * TH;
  for (int i = tid; i < TH * nwin; i += TX * TY) {
    const size_t g = (size_t)y0 * nwin + i;
    s_t[i] = y0 + i / nwin < h ? make_float2(sdphi2[g], po[g])
                               : make_float2(BIG, 0.0f);
  }
  __syncthreads();

  const int x = blockIdx.x * TW + 4 * threadIdx.x;
  const int r0 = y0 + threadIdx.y * R;  // this thread's first output row
  const int mrows = h + 2 * k;
  const float2* t = s_t + threadIdx.y * R * nwin;
  float4 acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = make_float4(BIG, BIG, BIG, BIG);

  const int nrows = R + 2 * k;  // Mmin rows r0 .. r0 + nrows - 1
  for (int m0 = 0; m0 < nrows; m0 += DEPTH) {
    float4 v[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
      v[u] = m0 + u < nrows ? load_row<VEC>(mmin, r0 + m0 + u, mrows, x, w)
                            : make_float4(BIG, BIG, BIG, BIG);
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const float4 lo = v[u];
      const bool src = fminf(fminf(lo.x, lo.y), fminf(lo.z, lo.w)) <
                       0.5f * BIG;
      if (!__any_sync(0xffffffffu, src)) continue;
      const int m = m0 + u;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int di = m - j;
        if (di < 0 || di > 2 * k) continue;
        const float2 tj = t[j * nwin + di];
        tap(acc[j].x, tj, lo.x);
        tap(acc[j].y, tj, lo.y);
        tap(acc[j].z, tj, lo.z);
        tap(acc[j].w, tj, lo.w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int gy = r0 + j;
    if (gy >= h) break;
    float* p = out + (size_t)gy * w + x;
    if (VEC && x + 3 < w) {
      *reinterpret_cast<float4*>(p) = acc[j];
    } else {
      if (x < w) p[0] = acc[j].x;
      if (x + 1 < w) p[1] = acc[j].y;
      if (x + 2 < w) p[2] = acc[j].z;
      if (x + 3 < w) p[3] = acc[j].w;
    }
  }
}

template <bool VEC>
int launch(const float* mmin, const float* sdphi2, const float* po,
           float* out, int h, int w, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * (size_t)TH * (2 * k + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pass2_min_window<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  pass2_min_window<VEC><<<grid, dim3(TX, TY), smem, stream>>>(
      mmin, sdphi2, po, out, h, w, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sbz_pass2_min(const float* mmin, const float* sdphi2,
                             const float* po, float* out, int h, int w, int k,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  return vec ? launch<true>(mmin, sdphi2, po, out, h, w, k, s)
             : launch<false>(mmin, sdphi2, po, out, h, w, k, s);
}
