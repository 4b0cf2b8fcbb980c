// Kernel B3: both passes of the separable coast-distance minimum, fused per
// tile, for Hopper.
//
// Replaces seabreeze_param_tpu/ops/pallas/distance_kernel.py::
// min_haversine_param_pallas_padded (body _kernel), single-extremum form:
//
//   pass 1:  Mmin[r, x] = min over dj in [0, 2k] with cpad[r, x+dj] > 0
//                         of sdlam2[x, dj]            (BIG if none)
//   pass 2:  amin[y, x] = min over di in [0, 2k] of
//                         sdphi2[y, di] + po[y, di] * Mmin[y+di, x],
//
// a pass-2 candidate being BIG where Mmin is BIG.  Plain version:
// seabreeze_param_tpu_torch/ops/distance.py::min_haversine_param_from_padded
// (pass2_min of pass1_extrema).
//
// What bounds it on an H100: shared-memory reads.  Each output cell costs
// (TH+2k)/TH * (2k+1) pass-1 taps and 2k+1 pass-2 taps (about 120 at
// k = 15), all from shared memory; device memory sees the coast strip
// ((TH+2k)(TW+2k)/(TH*TW) reads per cell, 2.9 at k = 15), the small tables
// and one write.  The plain torch version sweeps the padded field 2k+1
// times in pass 1 and the pass-1 field 2k+1 times in pass 2.
//
// Design: one block per TH x TW = 16 x 32 tile, one thread per output cell.
// * The block loads its (TH+2k) x (TW+2k) coast strip from pad_coast's
//   output (zero lat rows and periodic columns already in place; beyond the
//   padded field: 0, never a coast cell), its sdlam2 columns transposed to
//   (2k+1) x TW, and its sdphi2/po rows, into dynamic shared memory (25 KB
//   at k = 15).
// * A strip with no coast cell can only give BIG: the block writes BIG and
//   skips both passes (__syncthreads_or), as the TPU kernel does.
// * Pass 1 writes the (TH+2k) x TW masked minima into shared memory; pass 2
//   reads its column of them.  The multiply and the add of pass 2 are
//   rounded separately (__fmul_rn, __fadd_rn): nvcc would otherwise
//   contract them into an FMA, and the result is then bit-equal to the
//   plain version, which runs them as two torch ops (as kernel B2 does).
#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;  // tile rows = threads along y
constexpr int TW = 32;  // tile columns = threads along x (one warp per row)
constexpr int NT = TH * TW;
constexpr float BIG = 1.0e30f;

__global__ void __launch_bounds__(NT)
min_haversine_kernel(const float* __restrict__ cpad,
                     const float* __restrict__ sdphi2,
                     const float* __restrict__ po,
                     const float* __restrict__ sdlam2,
                     float* __restrict__ out, int h, int w, int k) {
  const int nwin = 2 * k + 1;
  const int SH = TH + 2 * k, SW = TW + 2 * k;  // strip extents
  const int ph = h + 2 * k, pw = w + 2 * k;    // padded field extents
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;

  extern __shared__ float smem[];
  float* s_c = smem;              // SH x SW     coast strip
  float* s_m = s_c + SH * SW;     // SH x TW     pass-1 minima
  float* s_l = s_m + SH * TW;     // nwin x TW   sdlam2, transposed
  float* s_s = s_l + nwin * TW;   // TH x nwin   sdphi2 rows
  float* s_p = s_s + TH * nwin;   // TH x nwin   po rows

  bool any_coast = false;
  for (int i = tid; i < SH * SW; i += NT) {
    const int r = i / SW, cc = i - r * SW;
    const int gr = r0 + r, gc = c0 + cc;
    const float v = gr < ph && gc < pw ? cpad[(size_t)gr * pw + gc] : 0.0f;
    s_c[i] = v;
    any_coast |= v > 0.0f;
  }
  for (int i = tid; i < TW * nwin; i += NT) {
    const int xx = i / nwin, dj = i - xx * nwin;
    s_l[dj * TW + xx] =
        c0 + xx < w ? sdlam2[(size_t)c0 * nwin + i] : BIG;
  }
  for (int i = tid; i < TH * nwin; i += NT) {
    const bool ok = r0 + i / nwin < h;
    s_s[i] = ok ? sdphi2[(size_t)r0 * nwin + i] : BIG;
    s_p[i] = ok ? po[(size_t)r0 * nwin + i] : 0.0f;
  }
  const int x = c0 + tx, y = r0 + ty;
  if (!__syncthreads_or(any_coast)) {
    if (y < h && x < w) out[(size_t)y * w + x] = BIG;
    return;
  }

  // pass 1: per strip row, the masked min over the lon window
  for (int r = ty; r < SH; r += TH) {
    const float* row = s_c + r * SW + tx;
    float m = BIG;
    for (int dj = 0; dj < nwin; ++dj) {
      if (row[dj] > 0.0f) m = fminf(m, s_l[dj * TW + tx]);
    }
    s_m[r * TW + tx] = m;
  }
  __syncthreads();

  // pass 2: the min over the lat window, empty row windows poisoned
  if (y >= h || x >= w) return;
  const float* ss = s_s + ty * nwin;
  const float* pp = s_p + ty * nwin;
  float amin = BIG;
  for (int di = 0; di < nwin; ++di) {
    const float lo = s_m[(ty + di) * TW + tx];
    float cand = __fadd_rn(ss[di], __fmul_rn(pp[di], lo));
    cand = lo > 0.5f * BIG ? BIG : cand;
    amin = fminf(amin, cand);
  }
  out[(size_t)y * w + x] = amin;
}

}  // namespace

extern "C" int sbz_min_haversine(const float* cpad, const float* sdphi2,
                                 const float* po, const float* sdlam2,
                                 float* out, int h, int w, int k,
                                 void* stream) {
  const size_t nwin = 2 * (size_t)k + 1;
  const size_t sh = TH + 2 * (size_t)k, sw = TW + 2 * (size_t)k;
  const size_t smem =
      sizeof(float) * (sh * sw + sh * TW + nwin * TW + 2 * TH * nwin);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        min_haversine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    // More than a block may hold (k too large): report it, and clear the
    // error so the next launch does not read it back as its own.
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const dim3 block(TW, TH);
  min_haversine_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      cpad, sdphi2, po, sdlam2, out, h, w, k);
  return (int)cudaGetLastError();
}
