// Kernels B1, B4 and B5: the expanding-ring THC search, for Hopper, in the
// three forms of the JAX package's ring kernels.  One device routine does
// the ring search for all three and one the trigger tail for B1 and B4, so
// the forms cannot drift apart.
//
// * B1 (STACKED) replaces seabreeze_param_tpu/ops/pallas/ring_kernel.py::
//   ring_trigger_pallas_stacked (body _trigger_kernel_stacked): ring search
//   + trigger tail, writing slot `step` of (T, h, w) output stacks and
//   updating the wind state in place, on the tiles of the ever-coastal set.
// * B4 (PADDED) replaces ring_trigger_pallas_padded (body _trigger_kernel):
//   the same math on every tile, returning the step's sb and the new wind
//   state (frozen in the nlats-1 row) in separate buffers.
// * B5 (THC) replaces ring_thc_pallas_padded (body _kernel): the ring
//   search alone, writing n_thc (zero off the coastal band).
//
// Plain versions: seabreeze_param_tpu_torch/ops/trigger.py::trigger_cells
// (B1, B4) and ops/ring_search.py::ring_thc_from_padded (B5).
//
// Per cell with |cd| <= maxdist (the coastal band), grow square windows
// nn = 1..NN over three channels of the NN-padded (t0, cd) fields — t0*land,
// land, t0*sea, land meaning cd >= 0 — and latch the window sums at the
// first radius holding both classes; n_thc = mul * (mean_land - mean_sea).
// Then the trigger tail: first-step seeding, four thresholds, scaling,
// MISSING off the band, the 6-hourly wind cadence and the nlats-1 row.
//
// What bounds it on an H100: shared-memory traffic and barriers.  The ring
// loop does about 30 shared-memory reads and writes per cell and radius and
// a block-wide barrier three times per radius; device memory sees only the
// two padded strips in and a few fields in or out per cell.
//
// Design:
// * One block per TH x TW = 16 x 32 tile, one thread per cell.  The TPU
//   tile (64, 128) with its scratch would not fit in a block's 227 KB.
// * The (t0, cd) strips of (TH+2NN) x (TW+2NN), the horizontal running sums
//   hp[3][TH+2NN][TW] and the vertical ones vc[3][TH][TW+2NN] live in
//   dynamic shared memory sized from NN (65 KB at NN = 19); the window sums
//   and the five latches live in registers.
// * Sums are taken in exactly the order of ring_search.py: hp += q[x-nn] +
//   q[x+nn]; W = W + top + bot + left + right; vc += q[y-nn] + q[y+nn].  Only
//   additions, so no FMA contraction can change them; the two divisions run
//   once, on the latched operands, as IEEE divisions (no fast math).
// * The tile exits the ring loop once every coastal cell has latched
//   (__syncthreads_and), as the TPU kernel's `done` flag does.
// * A tile with no coastal cell skips the strip load and the ring loop:
//   MISSING sb (n_thc 0 for B5) and the wind passed through.  B1 launches
//   over the full tile grid too, and a block whose tile is not in the
//   ever-coastal set (`ever`, kept on the device by the caller) returns at
//   once: its slots keep the caller's pre-filled defaults, which equal what
//   it would compute.  B4 has no such set and no pre-fill, so every tile
//   writes all of its outputs, the skipped ones included.
#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;  // tile rows = threads along y
constexpr int TW = 32;  // tile columns = threads along x (one warp per row)
constexpr int NT = TH * TW;
constexpr float MISSING = 2.0e20f;
constexpr float SENTINEL = 12000.0f;

enum Mode { STACKED = 0, PADDED = 1, THC = 2 };

// The three ring channels of one padded cell: t0*land, land, t0*sea.
__device__ __forceinline__ void quants(float t0, float cd, float& tl,
                                       float& land, float& ts) {
  land = cd >= 0.0f ? 1.0f : 0.0f;
  tl = __fmul_rn(t0, land);
  ts = __fsub_rn(t0, tl);
}

// Floor modulo by 360 (jnp.mod / torch.remainder), not C's fmod.
__device__ __forceinline__ float floor_mod360(float x) {
  float r = fmodf(x, 360.0f);
  if (r != 0.0f && r < 0.0f) r += 360.0f;
  return r;
}

struct Scalars {
  int h, w, nn, is_first, upd, row_offset, row_limit;
  float maxdist, thresh_wind, thresh_winddir, thresh_windch, thresh_thc;
};

// Every mode's buffers; a mode leaves the ones it does not use null.
struct Fields {
  const float* t0_pad;  // (h+2NN, w+2NN)
  const float* cd_pad;  // (h+2NN, w+2NN)
  const float* cd;      // (h, w) unpadded signed coast distance
  const float* ws_new;  // (h, w) this step's wind at the target level
  const float* wd_new;
  float* ws_state;      // (h, w) carried wind: B1 updates it in place,
  float* wd_state;      //        B4 only reads it
  const unsigned char* ever;  // B1: (ni * nj) ever-coastal tile mask
  float* sb_out;        // B1: slot of the sb stack; B4: sb; B5: n_thc
  float* ws_out;        // B1: slots of the ws/wd stacks; B4: the new state
  float* wd_out;
};

// Ring search of one tile, run by every thread of the block (it holds
// block-wide barriers).  Loads the strips of the tile at (r0, c0) and
// returns the cell's n_thc (0 off the band and outside the field).
__device__ float ring_thc_tile(const Fields& f, const Scalars& s, int r0,
                               int c0, bool coastal, float cdc) {
  const int NN = s.nn;
  const int SH = TH + 2 * NN, SW = TW + 2 * NN;  // strip extents
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;  // padded field extents
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;

  extern __shared__ float smem[];
  float* s_t0 = smem;                // SH x SW
  float* s_cd = s_t0 + SH * SW;      // SH x SW
  float* s_hp = s_cd + SH * SW;      // 3 x SH x TW
  float* s_vc = s_hp + 3 * SH * TW;  // 3 x TH x SW
  const int HP = SH * TW, VC = TH * SW;

  for (int i = tid; i < SH * SW; i += NT) {
    const int r = i / SW, cc = i - r * SW;
    const int gr = r0 + r, gc = c0 + cc;
    const bool ok = gr < ph && gc < pw;  // the ragged edge: fill
    s_t0[i] = ok ? f.t0_pad[(size_t)gr * pw + gc] : 0.0f;
    s_cd[i] = ok ? f.cd_pad[(size_t)gr * pw + gc] : SENTINEL;
  }
  __syncthreads();

  // Order-0 running sums: hp over all strip rows, vc over all strip columns.
  for (int i = tid; i < HP; i += NT) {
    const int r = i / TW, xx = i - r * TW;
    const int si = r * SW + xx + NN;
    quants(s_t0[si], s_cd[si], s_hp[i], s_hp[HP + i], s_hp[2 * HP + i]);
  }
  for (int i = tid; i < VC; i += NT) {
    const int yy = i / SW, cc = i - yy * SW;
    const int si = (yy + NN) * SW + cc;
    quants(s_t0[si], s_cd[si], s_vc[i], s_vc[VC + i], s_vc[2 * VC + i]);
  }
  float W0, W1, W2;
  {
    const int si = (ty + NN) * SW + tx + NN;
    quants(s_t0[si], s_cd[si], W0, W1, W2);
  }
  float lat_tl = 0.0f, lat_nl = 1.0f, lat_ts = 0.0f, lat_ns = 1.0f;
  bool found = false;
  __syncthreads();

  for (int nn = 1; nn <= NN; ++nn) {
    // widen the horizontal running sum to order nn
    for (int i = tid; i < HP; i += NT) {
      const int r = i / TW, xx = i - r * TW;
      const int sl = r * SW + xx + NN - nn, sr = r * SW + xx + NN + nn;
      float a0, a1, a2, b0, b1, b2;
      quants(s_t0[sl], s_cd[sl], a0, a1, a2);
      quants(s_t0[sr], s_cd[sr], b0, b1, b2);
      s_hp[i] = (s_hp[i] + a0) + b0;
      s_hp[HP + i] = (s_hp[HP + i] + a1) + b1;
      s_hp[2 * HP + i] = (s_hp[2 * HP + i] + a2) + b2;
    }
    __syncthreads();
    // window: two full-width rows (hp, order nn), two partial columns
    // (vc, order nn-1)
    {
      const int top = (ty + NN - nn) * TW + tx, bot = (ty + NN + nn) * TW + tx;
      const int lft = ty * SW + tx + NN - nn, rgt = ty * SW + tx + NN + nn;
      W0 = (((W0 + s_hp[top]) + s_hp[bot]) + s_vc[lft]) + s_vc[rgt];
      W1 = (((W1 + s_hp[HP + top]) + s_hp[HP + bot]) + s_vc[VC + lft]) +
           s_vc[VC + rgt];
      W2 = (((W2 + s_hp[2 * HP + top]) + s_hp[2 * HP + bot]) +
            s_vc[2 * VC + lft]) + s_vc[2 * VC + rgt];
    }
    __syncthreads();
    // then widen the vertical running sum for the next radius
    for (int i = tid; i < VC; i += NT) {
      const int yy = i / SW, cc = i - yy * SW;
      const int st = (yy + NN - nn) * SW + cc, sb = (yy + NN + nn) * SW + cc;
      float a0, a1, a2, b0, b1, b2;
      quants(s_t0[st], s_cd[st], a0, a1, a2);
      quants(s_t0[sb], s_cd[sb], b0, b1, b2);
      s_vc[i] = (s_vc[i] + a0) + b0;
      s_vc[VC + i] = (s_vc[VC + i] + a1) + b1;
      s_vc[2 * VC + i] = (s_vc[2 * VC + i] + a2) + b2;
    }
    // latch at the first radius holding both classes (never found: the
    // NN-window value)
    const float n_s = (float)((2 * nn + 1) * (2 * nn + 1)) - W1;  // exact
    const bool ok = W1 > 0.0f && n_s > 0.0f;
    if (!found && (ok || nn == NN)) {
      lat_tl = W0;
      lat_nl = fmaxf(W1, 1.0f);
      lat_ts = W2;
      lat_ns = fmaxf(n_s, 1.0f);
    }
    found = found || ok;
    if (__syncthreads_and(found || !coastal)) break;
  }
  const float mul = cdc >= 0.0f ? 1.0f : -1.0f;
  return coastal ? mul * (lat_tl / lat_nl - lat_ts / lat_ns) : 0.0f;
}

// The trigger tail of one cell (seabreeze_diag_python.f90:236-274): sb and
// the wind the state takes this step (before the nlats-1 row rule).
__device__ __forceinline__ void trigger_tail(
    float n_thc, bool coastal, float wsn, float wdn, float wss, float wds,
    const Scalars& s, float& sb, float& ws_o, float& wd_o) {
  const bool fc = s.is_first && coastal;
  const float ws_base = fc ? wsn : wss;
  const float wd_base = fc ? wdn : wds;
  const float thc_abs = fabsf(n_thc);
  const float mws = (ws_base + wsn) * 0.5f;
  const float dws = fabsf(ws_base - wsn);
  const float dwd = fabsf(floor_mod360((wd_base - wdn) + 180.0f) - 180.0f);
  const bool cond = dwd < s.thresh_winddir && dws < s.thresh_windch &&
                    mws < s.thresh_wind && thc_abs > s.thresh_thc;
  const float scale_wind = (s.thresh_wind - mws) / fmaxf(1.0f, mws);
  const float thc_safe = n_thc == 0.0f ? 1.0f : n_thc;
  const float scale_thc = (thc_abs - s.thresh_thc) / thc_safe;
  sb = coastal ? (cond ? __fmul_rn(scale_thc, scale_wind) : 0.0f) : MISSING;
  const bool take = coastal && (s.is_first || s.upd);
  ws_o = take ? wsn : wss;
  wd_o = take ? wdn : wds;
}

template <int MODE>
__global__ void __launch_bounds__(NT)
ring_kernel(const Fields f, const Scalars s) {
  if (MODE == STACKED && !f.ever[blockIdx.y * gridDim.x + blockIdx.x]) return;

  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int x = c0 + threadIdx.x, y = r0 + threadIdx.y;
  const bool inside = x < s.w && y < s.h;
  const size_t c = (size_t)y * s.w + x;

  const float cdc = inside ? f.cd[c] : SENTINEL;
  const bool coastal = inside && fabsf(cdc) <= s.maxdist;
  const bool row_ok = s.row_offset + y < s.row_limit;
  const float wss = (MODE != THC && inside) ? f.ws_state[c] : 0.0f;
  const float wds = (MODE != THC && inside) ? f.wd_state[c] : 0.0f;

  if (!__syncthreads_or(coastal)) {
    if (!inside) return;
    if (MODE == THC) {
      f.sb_out[c] = 0.0f;
    } else {
      f.sb_out[c] = row_ok ? MISSING : 0.0f;
      // B1: output slots (zero in the last row); B4: the state, passed on
      f.ws_out[c] = (MODE == PADDED || row_ok) ? wss : 0.0f;
      f.wd_out[c] = (MODE == PADDED || row_ok) ? wds : 0.0f;
    }
    return;
  }

  const float n_thc = ring_thc_tile(f, s, r0, c0, coastal, cdc);
  if (!inside) return;
  if (MODE == THC) {
    f.sb_out[c] = n_thc;
    return;
  }

  float sb, ws_o, wd_o;
  trigger_tail(n_thc, coastal, f.ws_new[c], f.wd_new[c], wss, wds, s, sb,
               ws_o, wd_o);
  f.sb_out[c] = row_ok ? sb : 0.0f;
  if (MODE == PADDED) {  // the new state, frozen in the nlats-1 row
    f.ws_out[c] = row_ok ? ws_o : wss;
    f.wd_out[c] = row_ok ? wd_o : wds;
  } else {
    f.ws_out[c] = row_ok ? ws_o : 0.0f;
    f.wd_out[c] = row_ok ? wd_o : 0.0f;
    if (row_ok) {  // the nlats-1 row keeps its state
      f.ws_state[c] = ws_o;
      f.wd_state[c] = wd_o;
    }
  }
}

// Launch one mode over the full tile grid of an (h, w) field; returns
// cudaGetLastError().
template <int MODE>
int launch(const Fields& f, const Scalars& s, void* stream) {
  const size_t sh = TH + 2 * s.nn, sw = TW + 2 * s.nn;
  const size_t smem = sizeof(float) * (2 * sh * sw + 3 * sh * TW + 3 * TH * sw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    // More than a block may hold (nn too large): report it, and clear the
    // error so the next launch does not read it back as its own.
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const dim3 grid((s.w + TW - 1) / TW, (s.h + TH - 1) / TH);
  const dim3 block(TW, TH);
  ring_kernel<MODE><<<grid, block, smem, (cudaStream_t)stream>>>(f, s);
  return (int)cudaGetLastError();
}

Scalars make_scalars(int h, int w, int nn, int is_first, int upd,
                     int row_offset, int nlat_total, int skip_last_row,
                     float maxdist, float thresh_wind, float thresh_winddir,
                     float thresh_windch, float thresh_thc) {
  return Scalars{h, w, nn, is_first, upd, row_offset,
                 skip_last_row ? nlat_total - 1 : nlat_total,
                 maxdist, thresh_wind, thresh_winddir, thresh_windch,
                 thresh_thc};
}

}  // namespace

extern "C" int sbz_ring_trigger_stacked(
    const float* t0_pad, const float* cd_pad, const float* cd,
    const float* ws_new, const float* wd_new, float* ws_state,
    float* wd_state, const unsigned char* ever, float* sb_buf, float* ws_buf,
    float* wd_buf, int h, int w, int nn, int step, int is_first, int upd,
    int row_offset, int nlat_total, int skip_last_row, float maxdist,
    float thresh_wind, float thresh_winddir, float thresh_windch,
    float thresh_thc, void* stream) {
  const size_t slot = (size_t)step * h * w;
  const Fields f{t0_pad, cd_pad, cd, ws_new, wd_new, ws_state, wd_state,
                 ever, sb_buf + slot, ws_buf + slot, wd_buf + slot};
  return launch<STACKED>(
      f, make_scalars(h, w, nn, is_first, upd, row_offset, nlat_total,
                      skip_last_row, maxdist, thresh_wind, thresh_winddir,
                      thresh_windch, thresh_thc),
      stream);
}

extern "C" int sbz_ring_trigger_padded(
    const float* t0_pad, const float* cd_pad, const float* cd,
    const float* ws_new, const float* wd_new, const float* ws_state,
    const float* wd_state, float* sb_out, float* ws_out, float* wd_out,
    int h, int w, int nn, int is_first, int upd, int row_offset,
    int nlat_total, int skip_last_row, float maxdist, float thresh_wind,
    float thresh_winddir, float thresh_windch, float thresh_thc,
    void* stream) {
  // B4 never writes the state it reads
  const Fields f{t0_pad, cd_pad, cd, ws_new, wd_new,
                 const_cast<float*>(ws_state), const_cast<float*>(wd_state),
                 nullptr, sb_out, ws_out, wd_out};
  return launch<PADDED>(
      f, make_scalars(h, w, nn, is_first, upd, row_offset, nlat_total,
                      skip_last_row, maxdist, thresh_wind, thresh_winddir,
                      thresh_windch, thresh_thc),
      stream);
}

extern "C" int sbz_ring_thc_padded(const float* t0_pad, const float* cd_pad,
                                   const float* cd, float* n_thc, int h,
                                   int w, int nn, float maxdist,
                                   void* stream) {
  const Fields f{t0_pad, cd_pad, cd, nullptr, nullptr, nullptr, nullptr,
                 nullptr, n_thc, nullptr, nullptr};
  return launch<THC>(
      f, make_scalars(h, w, nn, 0, 0, 0, h, 0, maxdist, 0.0f, 0.0f, 0.0f,
                      0.0f),
      stream);
}
