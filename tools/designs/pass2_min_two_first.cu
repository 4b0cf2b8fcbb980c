// The first Hopper builds of kernel B2's two-extremum form (csrc/
// pass2_min.cu, sbz_pass2_min_two, before its redesign), kept to be timed
// beside the port's (tools/compare_designs.py --only B2two):
//
//   amin[y, x] = min over di in [0, 2k] of sdphi2[y, di] +
//                min(po[y, di] * Mmin[y + di, x], po[y, di] * Mmax[y + di, x]),
//
// BIG where Mmin > BIG/2.  Every tap reads both extrema.
// * Staged build, k <= 93: one block per 16 x 128 tile stages a strip of
//   Mmin and a strip of Mmax (-BIG beyond the field) beside each other with
//   cp.async, then runs every tap from shared memory; at k = 93 the two
//   strips fill ~225 KB, one block an SM.
// * Past k = 93: the pass-2 routine of csrc/pass2_pruned.cuh (one warp per
//   output row and band of 64 columns, the taps centre-out in groups of 8
//   steps, table entries by shuffle) with a second channel and no early
//   exit: every tap of every cell.
// The exported functions are the port's sbz_pass2_min_two (without the
// scratch argument) and sbz_pass2_min_two_limits.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;  // tile columns = threads along x
constexpr int TY = 4;    // threads along y
constexpr int NT = TW * TY;
constexpr int TH = 16;   // tile rows; each thread owns TH / TY of them
constexpr float BIG = 1.0e30f;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold

constexpr size_t staged_smem(int k) {
  return sizeof(float) * 2 * (size_t)(TH + 2 * k) * TW +
         sizeof(float) * 2 * (size_t)TH * (2 * k + 1);
}
constexpr int max_staged_k() {
  int k = 0;
  while (staged_smem(k + 1) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_STAGED_K2 = max_staged_k();

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

template <bool VEC>
__global__ void __launch_bounds__(NT)
staged_two_kernel(const float* __restrict__ mmin,
                  const float* __restrict__ mmax,
                  const float* __restrict__ sdphi2,
                  const float* __restrict__ po, float* __restrict__ out,
                  int h, int w, int k) {
  extern __shared__ float4 smem4[];
  const int nwin = 2 * k + 1;
  const int rows = TH + 2 * k;
  float* s_m = reinterpret_cast<float*>(smem4);
  float* s_x = s_m + rows * TW;
  float2* s_t = reinterpret_cast<float2*>(s_x + rows * TW);

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int mrows = h + 2 * k;

  constexpr int PIECE = VEC ? 4 : 1;
  constexpr int PER_ROW = TW / PIECE;
  for (int i = tid; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * PIECE;
    const int gy = y0 + r, gx = x0 + c;
    float* dst = s_m + r * TW + c;
    if (gy < mrows && gx + PIECE <= w) {
      cp_async(dst, mmin + (size_t)gy * w + gx, PIECE * 4);
      cp_async(dst + rows * TW, mmax + (size_t)gy * w + gx, PIECE * 4);
    } else {
#pragma unroll
      for (int u = 0; u < PIECE; ++u) {
        const bool in = gy < mrows && gx + u < w;
        dst[u] = in ? mmin[(size_t)gy * w + gx + u] : BIG;
        dst[rows * TW + u] = in ? mmax[(size_t)gy * w + gx + u] : -BIG;
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
        const float prod = fminf(__fmul_rn(tap.y, lo),
                                 __fmul_rn(tap.y, m[rows * TW + di * TW]));
        float cand = __fadd_rn(tap.x, prod);
        cand = lo > 0.5f * BIG ? BIG : cand;
        amin = fminf(amin, cand);
      }
    }
    out[(size_t)gy * w + x] = amin;
  }
}

template <bool VEC>
int launch_staged(const float* mmin, const float* mmax, const float* sdphi2,
                  const float* po, float* out, int h, int w, int k,
                  cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const dim3 block(TW, TY);
  const size_t smem = staged_smem(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        staged_two_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  staged_two_kernel<VEC><<<grid, block, smem, stream>>>(mmin, mmax, sdphi2,
                                                        po, out, h, w, k);
  return (int)cudaGetLastError();
}

// the pass-2 routine's constants (csrc/pass2_pruned.cuh)
constexpr int CPL = 2;
constexpr int BAND = 32 * CPL;
constexpr int GROUP = 8;
constexpr int WARPS = 4;
constexpr int PNT = 32 * WARPS;

__global__ void __launch_bounds__(PNT)
pruned_two_kernel(const float* __restrict__ mmin,
                  const float* __restrict__ mmax,
                  const float* __restrict__ sdphi2,
                  const float* __restrict__ po, float* __restrict__ out,
                  int h, int w, int k) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (y >= h) return;
  const int nwin = 2 * k + 1, x0 = blockIdx.x * BAND + lane;
  bool xin[CPL];
  float acc[CPL];
  const float* m[CPL];
  const float* mx[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    xin[c] = x0 + 32 * c < w;
    acc[c] = BIG;
    const size_t i = (size_t)(y + k) * w + min(x0 + 32 * c, w - 1);
    m[c] = mmin + i;
    mx[c] = mmax + i;
  }
  const float* tp = sdphi2 + (size_t)y * nwin + k;
  const float* tq = po + (size_t)y * nwin + k;
  float tm = 0.0f, tpl = 0.0f, qm = 0.0f, qpl = 0.0f;
  for (int j = 0; j <= k; j += GROUP) {
    float t[2 * GROUP], q[2 * GROUP], v[2 * GROUP][CPL], u[2 * GROUP][CPL];
    if ((j & 31) == 0) {
      const int d = min(j + lane, k);
      tm = __ldg(tp - d), tpl = __ldg(tp + d);
      qm = __ldg(tq - d), qpl = __ldg(tq + d);
    }
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
        v[2 * g][c] = __ldg(m[c] - off);
        v[2 * g + 1][c] = __ldg(m[c] + off);
        u[2 * g][c] = __ldg(mx[c] - off);
        u[2 * g + 1][c] = __ldg(mx[c] + off);
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * GROUP; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float lo = v[i][c];
        const float cand = __fadd_rn(
            t[i], fminf(__fmul_rn(q[i], lo), __fmul_rn(q[i], u[i][c])));
        acc[c] = fminf(acc[c], lo > 0.5f * BIG ? BIG : cand);
      }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (xin[c]) out[(size_t)y * w + x0 + 32 * c] = acc[c];
}

}  // namespace

extern "C" int sbz_pass2_min_two_limits(int* max_staged_k) {
  *max_staged_k = MAX_STAGED_K2;
  return 0;
}

extern "C" int sbz_pass2_min_two(const float* mmin, const float* mmax,
                                 const float* sdphi2, const float* po,
                                 float* out, int h, int w, int k,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (k > MAX_STAGED_K2) {
    const dim3 grid((w + BAND - 1) / BAND, (h + WARPS - 1) / WARPS);
    pruned_two_kernel<<<grid, PNT, 0, s>>>(mmin, mmax, sdphi2, po, out, h, w,
                                           k);
    return (int)cudaGetLastError();
  }
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0 &&
                   (uintptr_t)mmax % 16 == 0;
  return vec ? launch_staged<true>(mmin, mmax, sdphi2, po, out, h, w, k, s)
             : launch_staged<false>(mmin, mmax, sdphi2, po, out, h, w, k, s);
}
