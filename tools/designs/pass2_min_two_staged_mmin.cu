// A staged build of kernel B2's two-extremum form that lost to the port's
// (csrc/pass2_min.cu, pass2_min_kernel<VEC, true>, the first design), kept to
// be timed beside it (tools/compare_designs.py --only B2two, build
// two_staged_mmin):
//
//   amin[y, x] = min over di in [0, 2k] of sdphi2[y, di] +
//                min(po[y, di] * Mmin[y + di, x], po[y, di] * Mmax[y + di, x]),
//
// BIG where Mmin > BIG/2, k <= 93 only.  It copies the tile's table rows,
// then its Mmin strip, as two groups of cp.async; once the table rows are
// in it stages the Mmax strip only where some po of the tile is < 0.  A
// tile whose po are all >= 0 (every tile of a grid's own tables) reads Mmin
// alone, one load a tap; another reads both strips and takes both
// products.  On a grid's po it runs at the single form's time, 14-22%
// ahead of the port's build at k <= 93; on po drawn from [-1, 1], the
// form's own traffic, 1-17% behind it at k <= 31 and at 0.1 deg (PERF.md).
// The exported functions are the port's sbz_pass2_min_two without its
// scratch argument (refusing k > 93) and sbz_pass2_min_two_limits.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float candidate(float t, float q, float lo) {
  const float c = __fadd_rn(t, __fmul_rn(q, lo));
  return lo > 0.5f * BIG ? BIG : c;
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
  // the table rows (one group of copies), then the Mmin strip (a second
  // group); once the first group is in, the Mmax strip where some po of
  // the tile is < 0 (never on a grid's own tables)
  for (int i = tid; i < TH * nwin; i += NT) {
    const size_t g = (size_t)y0 * nwin + i;
    float* e = reinterpret_cast<float*>(s_t + i);
    if (y0 + i / nwin < h) {
      cp_async(e, sdphi2 + g, 4);
      cp_async(e + 1, po + g, 4);
    } else {
      e[0] = BIG, e[1] = 0.0f;
    }
  }
  cp_async_commit();
  for (int i = tid; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * PIECE;
    const int gy = y0 + r, gx = x0 + c;
    const size_t g = (size_t)gy * w + gx;
    float* dst = s_m + r * TW + c;
    if (gy < mrows && gx + PIECE <= w) {
      cp_async(dst, mmin + g, PIECE * 4);
    } else {
#pragma unroll
      for (int u = 0; u < PIECE; ++u)
        dst[u] = gy < mrows && gx + u < w ? mmin[g + u] : BIG;
    }
  }
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();
  bool neg = false;
  for (int i = tid; i < TH * nwin; i += NT) neg |= !(s_t[i].y >= 0.0f);
  const bool hi_on = __syncthreads_or(neg);
  if (hi_on) {
    for (int i = tid; i < rows * PER_ROW; i += NT) {
      const int r = i / PER_ROW, c = (i - r * PER_ROW) * PIECE;
      const int gy = y0 + r, gx = x0 + c;
      const size_t g = (size_t)gy * w + gx;
      float* dst = s_x + r * TW + c;
      if (gy < mrows && gx + PIECE <= w) {
        cp_async(dst, mmax + g, PIECE * 4);
      } else {
#pragma unroll
        for (int u = 0; u < PIECE; ++u)
          dst[u] = gy < mrows && gx + u < w ? mmax[g + u] : -BIG;
      }
    }
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
    const float2* t = s_t + r * nwin;
    const float* m = s_m + r * TW + tx;
    // the loops step their pointers: indexed from di, nvcc rebuilt the
    // shared addresses at every unrolled step (PERF.md)
    if (compute && !hi_on) {
      // every po of the tile >= 0: Mmin alone, one load a tap
      const float* lo = m;
#pragma unroll 4
      for (const float2* e = t; e < t + nwin; ++e, lo += TW)
        amin = fminf(amin, candidate(e->x, e->y, *lo));
    } else if (compute) {
      // both strips: the plain version's min of the two products, no
      // load or product waiting for the table entry's sign
      const float* lo = m;
#pragma unroll 4
      for (const float2* e = t; e < t + nwin; ++e, lo += TW) {
        const float hi = lo[rows * TW];
        const float c = __fadd_rn(
            e->x, fminf(__fmul_rn(e->y, *lo), __fmul_rn(e->y, hi)));
        amin = fminf(amin, *lo > 0.5f * BIG ? BIG : c);
      }
    }
    out[(size_t)gy * w + x] = amin;
  }
}

template <bool VEC>
int launch(const float* mmin, const float* mmax, const float* sdphi2,
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
  staged_two_kernel<VEC><<<grid, block, smem, stream>>>(
      mmin, mmax, sdphi2, po, out, h, w, k);
  return (int)cudaGetLastError();
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
  if (k > MAX_STAGED_K2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)mmin % 16 == 0 &&
                   (uintptr_t)mmax % 16 == 0;
  return vec ? launch<true>(mmin, mmax, sdphi2, po, out, h, w, k, s)
             : launch<false>(mmin, mmax, sdphi2, po, out, h, w, k, s);
}
