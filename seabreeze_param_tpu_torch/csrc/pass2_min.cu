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
// What bounds it on an H100: device memory.  Each output cell costs 2k+1
// multiply-add-select-min steps (31 at k = 15, 0.1 deg) against about 12
// bytes of traffic (its Mmin column read (TH+2k)/TH times, the write): about
// 10 operations per byte, under the card's fp32 ridge of about 20.  The plain torch version
// reads and writes the whole field 2k+1 times over; this kernel reads Mmin
// once per tile.
//
// Design: one block per (TH x TW) = (32 x 128) tile, 128 x 4 threads, each
// thread owning one column and TH/4 rows.  The block stages its (TH+2k) x TW
// Mmin strip in shared memory with loads coalesced along x, and its
// sdphi2/po rows beside it, then runs the tap loop from shared memory.  A
// block whose strip holds no source (every Mmin >= BIG/2) writes BIG and
// skips the loop, as _pass2_kernel does.  The multiply and the add are
// rounded separately (__fmul_rn, __fadd_rn): nvcc would otherwise contract
// them into an FMA, and the result is then bit-equal to the plain version,
// which runs them as two torch ops.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 128;  // tile columns = threads along x
constexpr int TY = 4;    // threads along y
constexpr int TH = 32;   // tile rows; each thread owns TH / TY of them
constexpr float BIG = 1.0e30f;

__global__ void __launch_bounds__(TW * TY)
pass2_min_kernel(const float* __restrict__ mmin,
                 const float* __restrict__ sdphi2,
                 const float* __restrict__ po, float* __restrict__ out,
                 int h, int w, int k) {
  extern __shared__ float smem[];
  const int nwin = 2 * k + 1;
  const int rows = TH + 2 * k;
  float* s_m = smem;               // rows x TW   Mmin strip
  float* s_s = s_m + rows * TW;    // TH x nwin   sdphi2 rows
  float* s_p = s_s + TH * nwin;    // TH x nwin   po rows

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TW + tx;
  const int y0 = blockIdx.y * TH;

  bool any_src = false;
  for (int r = ty; r < rows; r += TY) {
    const int gy = y0 + r;
    float v = BIG;  // beyond the field: an empty window
    if (gy < h + 2 * k && x < w) v = mmin[(size_t)gy * w + x];
    s_m[r * TW + tx] = v;
    any_src |= v < 0.5f * BIG;
  }
  for (int i = ty * TW + tx; i < TH * nwin; i += TW * TY) {
    const bool ok = y0 + i / nwin < h;
    s_s[i] = ok ? sdphi2[(size_t)y0 * nwin + i] : BIG;
    s_p[i] = ok ? po[(size_t)y0 * nwin + i] : 0.0f;
  }
  const bool compute = __syncthreads_or(any_src);

  for (int r = ty; r < TH; r += TY) {
    const int gy = y0 + r;
    if (gy >= h || x >= w) continue;
    float amin = BIG;
    if (compute) {
      const float* ss = s_s + r * nwin;
      const float* pp = s_p + r * nwin;
      for (int di = 0; di < nwin; ++di) {
        const float lo = s_m[(r + di) * TW + tx];
        float cand = __fadd_rn(ss[di], __fmul_rn(pp[di], lo));
        cand = lo > 0.5f * BIG ? BIG : cand;
        amin = fminf(amin, cand);
      }
    }
    out[(size_t)gy * w + x] = amin;
  }
}

}  // namespace

extern "C" int sbz_pass2_min(const float* mmin, const float* sdphi2,
                             const float* po, float* out, int h, int w, int k,
                             void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(TH + 2 * k) * TW + 2 * (size_t)TH * (2 * k + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pass2_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    // More than a block may hold (k too large): report it, and clear the
    // error so the next launch does not read it back as its own.
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  const dim3 block(TW, TY);
  pass2_min_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      mmin, sdphi2, po, out, h, w, k);
  return (int)cudaGetLastError();
}
