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
// What bounds it on an H100.  The least time is set by device memory: 48
// bytes per cell of the coastal tiles (seven fields in, five out); the
// ring loop's additions are far below the float32 rate.  What it takes is
// each coastal tile's chain of dependent steps at two resident blocks per
// SM: its strip from device memory, the running sums through shared
// memory with a barrier per radius (~5.6 sum updates per cell and radius
// at NN = 19, the 16 x 32 tile's halo), the lookups and the tail; fewer
// bytes per update and fewer barriers shortened it, fewer updates alone
// did not.  And a block for every tile of the field would be 85-95%
// blocks that return at once (~20 us of a 0.1-degree step on an H100).
// Two answers to the chain were measured slower (tools/designs/
// ring_trigger_variants.cu, PERF.md): staging the next tile's strip with
// cp.async during this tile's ring loop (the second resident block on
// the SM already hides one block's loads behind the other's loop), and
// 32 x 32 tiles of two cells per thread (96 registers: one block per SM).
//
// Design (TH x TW = 16 x 32 tiles, one thread per cell, NT = 512 threads):
// * B1 runs on persistent blocks.  Its grid is what the card holds at once
//   (blocks per SM from the occupancy calculator, times the SMs).  Every
//   block ranks the tiles set in the ever-coastal mask by one pass over
//   it (each thread reads up to 64 mask bytes at once, a block scan gives
//   the ranks) and runs those of rank b, b + G, b + 2G, ...  A tile outside
//   the set costs one byte, not a block; no host sync, no compaction
//   kernel, no atomics.  Dealing by rank, not by tile index, spreads the
//   clustered coastal tiles evenly (by tile index one block drew 4 of 324
//   tiles at 0.25 deg, 10 of 1204 at 0.1 deg).  B4 and B5, which write
//   every tile, keep one block per tile: the card's own scheduler overlaps
//   their many pass-through tiles better than a block walking them in turn.
// * Two channels only.  t0*land and t0*sea are computed once per strip
//   cell, when the strip lands, with the operations of ring_quantities
//   (land select, t0*land, t0 - t0*land), and kept as one float2.  The
//   land channel's window sums are whole numbers, exact in float, so they
//   come from an integral image of the strip's land mask instead: each
//   coastal cell finds its latch radius (the first window holding both
//   classes) and its land count there before the ring loop, and the tile
//   runs exactly the radii of its slowest coastal cell.
// * The running sums live in registers.  Each thread owns fixed elements
//   of the horizontal sums hp (rows of the strip x TW) and of the vertical
//   sums vc (TH x strip columns), updates them in registers and stores
//   each once per radius, for the window lookups, into one of two buffers:
//   a radius costs one barrier.  A cell past its latch radius stops
//   looking up.
// * Strip loads are batched four deep per thread from device memory.
// * Sums are taken in exactly the order of ring_search.py: hp += q[x-nn] +
//   q[x+nn]; W = W + top + bot + left + right (top/bot hp of order nn,
//   left/right vc of order nn-1); vc += q[y-nn] + q[y+nn].  Only
//   additions, so no FMA contraction can change them; the two divisions
//   run once, on the latched operands, as IEEE divisions (no fast math).
// * The integral image is dead before the running sums are first stored,
//   so the two share their shared memory; where two buffers of sums do not
//   fit a block (NN > 52), one does, at a second barrier per radius.
//   NN <= 57 fits an H100's 227 KB a block.
// * Larger radii (NN >= LARGE_FROM, up to MAX_NN) take the large build
//   (HS = VS = 0, ring_thc_tile_large): the strip of a kilometre-scale
//   grid (NN ~ 100-160) and its integral image far exceed a block's
//   shared memory, so nothing of the strip is kept there.  The running
//   sums live in shared memory (no register arrays, so no spills at any
//   NN), each element owned by one thread: hp rows ty, ty + 16, ... at
//   column tx, vc columns tx, tx + 32, ... of row ty, so every warp reads
//   32 neighbouring strip cells.  A radius reads the strip cells it adds
//   straight from t0_pad/cd_pad (L1/L2) and forms (tl, ts) with the
//   roundings of the strip load, so the sums are the same floats.  The
//   land channel is summed as 16-bit integers beside them (exact), which
//   gives each cell its latch and land count during the loop; the tile
//   stops after the radius at which its last coastal cell latched (a
//   block-wide vote in the radius's one barrier).  Two buffers of sums
//   fit a block up to NN = 109, one (a second barrier per radius) up to
//   MAX_NN = 224; larger radii are refused.
// * A tile with no coastal cell skips the strip load and the ring loop:
//   MISSING sb (n_thc 0 for B5) and the wind passed through.  B1's tiles
//   outside the ever-coastal set are never visited: their slots keep the
//   caller's pre-filled defaults, which equal what they would compute.  B4
//   has no such set and no pre-fill, so every tile writes all of its
//   outputs, the skipped ones included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;  // tile rows
constexpr int TW = 32;  // tile columns (one warp per tile row)
constexpr int NT = TH * TW;
constexpr int NWARP = NT / 32;
constexpr float MISSING = 2.0e20f;
constexpr float SENTINEL = 12000.0f;

enum Mode { STACKED = 0, PADDED = 1, THC = 2 };

// The most tiles one thread of B1 ranks per round of its persistent loop.
constexpr int RUN = 64;

// The first NN of the large build, and the last NN any build takes; the
// wrapper reads both through sbz_ring_limits.  LARGE_FROM is a build option
// only so that tools/compare_designs.py can time the large build below its
// threshold (-DSBZ_RING_LARGE_FROM=1); the port builds it at 58.
#ifndef SBZ_RING_LARGE_FROM
#define SBZ_RING_LARGE_FROM 58
#endif
constexpr int LARGE_FROM = SBZ_RING_LARGE_FROM;
constexpr int MAX_NN = 224;

// Dynamic shared memory of one block at ring radius nn: the strip of
// (TH+2nn) x (TW+2nn) padded cells, then nbuf buffers each of the hp rows
// (TH+2nn) x TW and the vc columns TH x (TW+2nn), one float2 (tl, ts) per
// element.  The strip's integral image of land, (TH+2nn+1) x (TW+2nn+1)
// ints, is dead before the running sums are first stored, so it shares
// their space.
size_t smem_bytes(int nn, int nbuf) {
  const size_t sh = TH + 2 * nn, sw = TW + 2 * nn;
  const size_t sums = sizeof(float2) * nbuf * (sh * TW + TH * sw);
  const size_t image = sizeof(int) * (sh + 1) * (sw + 1);
  return sizeof(float2) * sh * sw + (sums > image ? sums : image);
}

// The large build's: nbuf buffers of the hp and vc elements as float2 (tl,
// ts), then as many 16-bit land counts.  NN = 224 single-buffered: 220 KB.
size_t smem_bytes_large(int nn, int nbuf) {
  const size_t n = (TH + 2 * nn) * TW + TH * (TW + 2 * nn);
  return nbuf * n * (sizeof(float2) + sizeof(unsigned short));
}

// Floor modulo by 360 (jnp.mod / torch.remainder), not C's fmod.
__device__ __forceinline__ float floor_mod360(float x) {
  float r = fmodf(x, 360.0f);
  if (r != 0.0f && r < 0.0f) r += 360.0f;
  return r;
}

struct Scalars {
  int h, w, nn, is_first, upd, row_offset, row_limit;
  int nbuf;  // buffers of the running sums: 2 where they fit, else 1
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

__device__ __forceinline__ void add2(float2& v, const float2& a,
                                     const float2& b) {
  v.x = (v.x + a.x) + b.x;
  v.y = (v.y + a.y) + b.y;
}

// Inclusive prefix sums along `n` ints at p[0], p[stride], ... by one warp.
__device__ __forceinline__ void warp_prefix(int* p, int n, int stride,
                                            int lane) {
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    int v = i < n ? p[i * stride] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < n) p[i * stride] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Ring search of the tile at (r0, c0), run by every thread of the block
// (it holds block-wide barriers).  HS and VS are the hp and vc elements a
// thread owns at most.  Returns the cell's n_thc (0 off the band and
// outside the field).
template <int HS, int VS>
__device__ float ring_thc_tile(const Fields& f, const Scalars& s, int r0,
                               int c0, bool coastal, float cdc) {
  __shared__ int s_rmax[NWARP];
  const int NN = s.nn;
  const int SH = TH + 2 * NN, SW = TW + 2 * NN;  // strip extents
  const int IW = SW + 1;                         // integral image row
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;  // padded field extents
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int lane = tid % 32, warp = tid / 32;

  extern __shared__ float2 smem2[];
  float2* s_p = smem2;                 // SH x SW          (tl, ts)
  float2* s_h = s_p + SH * SW;         // nbuf x SH x TW   hp, order nn
  float2* s_v = s_h + s.nbuf * SH * TW;  // nbuf x TH x SW vc, order nn-1
  int* s_i = reinterpret_cast<int*>(s_h);  // (SH+1) x IW, before the sums

  // the strip, four loads in flight per thread; the ragged edge takes t0 0
  // and the land sentinel, as the plain version's padding never reaches.
  // Land goes to the integral image, row and column 0 of which are zero.
  const int n = SH * SW;
  for (int i = tid; i < n; i += 4 * NT) {
    float t0v[4], cdv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = i + u * NT;
      const int r = e / SW, cc = e - r * SW;
      const int gr = r0 + r, gc = c0 + cc;
      const bool ok = e < n && gr < ph && gc < pw;
      t0v[u] = ok ? f.t0_pad[(size_t)gr * pw + gc] : 0.0f;
      cdv[u] = ok ? f.cd_pad[(size_t)gr * pw + gc] : SENTINEL;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = i + u * NT;
      if (e < n) {
        const int r = e / SW, cc = e - r * SW;
        const float land = cdv[u] >= 0.0f ? 1.0f : 0.0f;
        const float tl = __fmul_rn(t0v[u], land);
        s_p[e] = make_float2(tl, __fsub_rn(t0v[u], tl));
        s_i[(r + 1) * IW + cc + 1] = cdv[u] >= 0.0f;
      }
    }
  }
  for (int i = tid; i < IW + SH; i += NT)
    s_i[i < IW ? i : (i - IW + 1) * IW] = 0;
  __syncthreads();
  for (int r = 1 + warp; r <= SH; r += NWARP)
    warp_prefix(s_i + r * IW + 1, SW, 1, lane);
  __syncthreads();
  for (int c = 1 + warp; c <= SW; c += NWARP)
    warp_prefix(s_i + IW + c, SH, IW, lane);
  __syncthreads();

  // Each coastal cell's latch radius: the first nn whose window holds both
  // classes (else NN), from box counts of land.  The counts are the sums
  // of the land channel (whole numbers, exact in float), so they need no
  // running sums; n_land at the latch is kept.
  int rc = 0, n_land = 0;
  if (coastal) {
    rc = NN;
    for (int nn = 1; nn <= NN; ++nn) {
      const int a = (ty + NN - nn) * IW, b = (ty + NN + nn + 1) * IW;
      const int l = tx + NN - nn, r = tx + NN + nn + 1;
      n_land = s_i[b + r] - s_i[a + r] - s_i[b + l] + s_i[a + l];
      if (n_land > 0 && n_land < (2 * nn + 1) * (2 * nn + 1)) {
        rc = nn;
        break;
      }
    }
  }
  const int wmax = __reduce_max_sync(0xffffffffu, rc);
  if (lane == 0) s_rmax[warp] = wmax;
  __syncthreads();  // the integral image is read; the sums take its space

  // order-0 running sums, each element owned by one thread; base: the
  // strip index of the element's centre (-1: no element)
  float2 hp[HS], vc[VS];
  int hb[HS], vb[VS];
#pragma unroll
  for (int k = 0; k < HS; ++k) {
    const int e = tid + k * NT;
    hb[k] = e < SH * TW ? (e / TW) * SW + e % TW + NN : -1;
    hp[k] = s_p[hb[k] < 0 ? 0 : hb[k]];
  }
#pragma unroll
  for (int k = 0; k < VS; ++k) {
    const int e = tid + k * NT;
    vb[k] = -1;
    if (e < TH * SW) {
      const int yy = e / SW;
      vb[k] = (yy + NN) * SW + e - yy * SW;
    }
    vc[k] = s_p[vb[k] < 0 ? 0 : vb[k]];
    if (vb[k] >= 0) s_v[(s.nbuf - 1) * TH * SW + e] = vc[k];  // read at nn 1
  }
  float2 W = s_p[(ty + NN) * SW + tx + NN];
  float lat_tl = 0.0f, lat_ts = 0.0f;
  __syncthreads();
  int R = 0;  // the tile's radii: its slowest coastal cell's latch radius
  for (int k = 0; k < NWARP; ++k) R = max(R, s_rmax[k]);

  // One barrier per radius where hp and vc are double-buffered, so that a
  // radius's stores never meet the previous radius's window reads; two
  // where one buffer is all that fits (NN > 52).
  for (int nn = 1; nn <= R; ++nn) {
    const int buf = s.nbuf == 2 ? (nn & 1) : 0;
    float2* hbuf = s_h + buf * SH * TW;
    float2* vbuf = s_v + buf * TH * SW;
    if (s.nbuf == 1 && nn > 1) __syncthreads();
    // vc to order nn-1 (order 0 is stored above), hp to order nn
    if (nn > 1) {
      const int m = (nn - 1) * SW;
#pragma unroll
      for (int k = 0; k < VS; ++k) {
        if (vb[k] < 0) continue;
        add2(vc[k], s_p[vb[k] - m], s_p[vb[k] + m]);
        vbuf[tid + k * NT] = vc[k];
      }
    }
#pragma unroll
    for (int k = 0; k < HS; ++k) {
      if (hb[k] < 0) continue;
      add2(hp[k], s_p[hb[k] - nn], s_p[hb[k] + nn]);
      hbuf[tid + k * NT] = hp[k];
    }
    __syncthreads();
    // window: two full-width rows (hp, order nn), two partial columns
    // (vc, order nn-1); a cell past its latch radius is done
    if (nn <= rc) {
      const float2 top = hbuf[(ty + NN - nn) * TW + tx];
      const float2 bot = hbuf[(ty + NN + nn) * TW + tx];
      const float2 lft = vbuf[ty * SW + tx + NN - nn];
      const float2 rgt = vbuf[ty * SW + tx + NN + nn];
      W.x = (((W.x + top.x) + bot.x) + lft.x) + rgt.x;
      W.y = (((W.y + top.y) + bot.y) + lft.y) + rgt.y;
      if (nn == rc) {
        lat_tl = W.x;
        lat_ts = W.y;
      }
    }
  }
  // the latched means; the counts are whole numbers, exact in float
  const float lat_nl = fmaxf((float)n_land, 1.0f);
  const float lat_ns =
      fmaxf((float)((2 * rc + 1) * (2 * rc + 1)) - (float)n_land, 1.0f);
  const float mul = cdc >= 0.0f ? 1.0f : -1.0f;
  return coastal ? mul * (lat_tl / lat_nl - lat_ts / lat_ns) : 0.0f;
}

// A strip cell read from device memory, as the strip load of ring_thc_tile
// forms it: (t0*land, t0 - t0*land) and land; outside the padded field t0
// 0 and the land sentinel.
struct StripCell {
  float t0, cd;
};

__device__ __forceinline__ StripCell strip_load(const Fields& f, int gr,
                                                int gc, int ph, int pw) {
  if (gr >= ph || gc >= pw) return StripCell{0.0f, SENTINEL};
  const size_t i = (size_t)gr * pw + gc;
  return StripCell{__ldg(f.t0_pad + i), __ldg(f.cd_pad + i)};
}

__device__ __forceinline__ float2 strip_q(const StripCell& c) {
  const float land = c.cd >= 0.0f ? 1.0f : 0.0f;
  const float tl = __fmul_rn(c.t0, land);
  return make_float2(tl, __fsub_rn(c.t0, tl));
}

// One running-sum element to its next order: v += q[-d] + q[+d], the land
// count likewise.
__device__ __forceinline__ void add_pair(float2& v, int& l,
                                         const StripCell& a,
                                         const StripCell& b) {
  add2(v, strip_q(a), strip_q(b));
  l += (a.cd >= 0.0f) + (b.cd >= 0.0f);
}

// The large build's ring search of the tile at (r0, c0) (NN >= LARGE_FROM),
// run by every thread of the block; the same n_thc, bit for bit, as
// ring_thc_tile.  Per radius nn: hp to order nn and vc to order nn-1, each
// thread its own elements (read from buffer `src`, written to `dst`), the
// strip cells they add read from device memory four elements deep; one
// barrier, which also asks whether any coastal cell is still to latch;
// then each such cell's window.
__device__ float ring_thc_tile_large(const Fields& f, const Scalars& s,
                                     int r0, int c0, bool coastal,
                                     float cdc) {
  constexpr int D = 4;  // elements whose strip cells are loaded at once
  const int NN = s.nn;
  const int SH = TH + 2 * NN, SW = TW + 2 * NN;
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int nh = SH * TW, nv = TH * SW;  // hp and vc elements

  extern __shared__ float2 smem2[];
  float2* s_sum = smem2;  // nbuf x (hp, vc)
  unsigned short* s_land =
      reinterpret_cast<unsigned short*>(smem2 + s.nbuf * (nh + nv));

  // order 0: hp into buffer 0, vc into the buffer radius 1 reads it from
  const int vb0 = s.nbuf - 1;
  for (int r = ty; r < SH; r += TH) {
    const StripCell c = strip_load(f, r0 + r, c0 + tx + NN, ph, pw);
    s_sum[r * TW + tx] = strip_q(c);
    s_land[r * TW + tx] = c.cd >= 0.0f;
  }
  for (int x = tx; x < SW; x += TW) {
    const StripCell c = strip_load(f, r0 + ty + NN, c0 + x, ph, pw);
    const int e = vb0 * (nh + nv) + nh + ty * SW + x;
    s_sum[e] = strip_q(c);
    s_land[e] = c.cd >= 0.0f;
  }
  const StripCell c0c = strip_load(f, r0 + ty + NN, c0 + tx + NN, ph, pw);
  float2 W = strip_q(c0c);
  int wl = c0c.cd >= 0.0f;

  bool pending = coastal;
  int rc = 0, n_land = 0;
  float lat_tl = 0.0f, lat_ts = 0.0f;
  for (int nn = 1; nn <= NN; ++nn) {
    const int src = s.nbuf == 2 ? ((nn - 1) & 1) * (nh + nv) : 0;
    const int dst = s.nbuf == 2 ? (nn & 1) * (nh + nv) : 0;
    if (s.nbuf == 1 && nn > 1) __syncthreads();
    // hp to order nn: rows ty, ty + TH, ... at column tx
    for (int r = ty; r < SH; r += D * TH) {
      StripCell a[D], b[D];
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int rr = r + u * TH, gr = rr < SH ? r0 + rr : ph;
        a[u] = strip_load(f, gr, c0 + tx + NN - nn, ph, pw);
        b[u] = strip_load(f, gr, c0 + tx + NN + nn, ph, pw);
      }
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int e = (r + u * TH) * TW + tx;
        if (r + u * TH >= SH) break;
        float2 v = s_sum[src + e];
        int l = s_land[src + e];
        add_pair(v, l, a[u], b[u]);
        s_sum[dst + e] = v;
        s_land[dst + e] = (unsigned short)l;
      }
    }
    // vc to order nn-1 (order 0 is stored above): columns tx, tx + TW, ...
    // of row ty
    if (nn > 1) {
      const int m = nn - 1;
      for (int x = tx; x < SW; x += D * TW) {
        StripCell a[D], b[D];
#pragma unroll
        for (int u = 0; u < D; ++u) {
          const int xx = x + u * TW, gc = xx < SW ? c0 + xx : pw;
          a[u] = strip_load(f, r0 + ty + NN - m, gc, ph, pw);
          b[u] = strip_load(f, r0 + ty + NN + m, gc, ph, pw);
        }
#pragma unroll
        for (int u = 0; u < D; ++u) {
          const int e = nh + ty * SW + x + u * TW;
          if (x + u * TW >= SW) break;
          float2 v = s_sum[src + e];
          int l = s_land[src + e];
          add_pair(v, l, a[u], b[u]);
          s_sum[dst + e] = v;
          s_land[dst + e] = (unsigned short)l;
        }
      }
    }
    if (!__syncthreads_or(pending)) break;  // every coastal cell latched
    // window: two full-width rows (hp, order nn), two partial columns (vc,
    // order nn-1); the first radius holding both classes latches
    if (pending) {
      const int t = dst + (ty + NN - nn) * TW + tx;
      const int bo = dst + (ty + NN + nn) * TW + tx;
      const int lf = dst + nh + ty * SW + tx + NN - nn;
      const int rg = dst + nh + ty * SW + tx + NN + nn;
      const float2 top = s_sum[t], bot = s_sum[bo];
      const float2 lft = s_sum[lf], rgt = s_sum[rg];
      W.x = (((W.x + top.x) + bot.x) + lft.x) + rgt.x;
      W.y = (((W.y + top.y) + bot.y) + lft.y) + rgt.y;
      wl += s_land[t] + s_land[bo] + s_land[lf] + s_land[rg];
      if ((wl > 0 && wl < (2 * nn + 1) * (2 * nn + 1)) || nn == NN) {
        rc = nn;
        n_land = wl;
        lat_tl = W.x;
        lat_ts = W.y;
        pending = false;
      }
    }
  }
  // the latched means, as ring_thc_tile takes them
  const float lat_nl = fmaxf((float)n_land, 1.0f);
  const float lat_ns =
      fmaxf((float)((2 * rc + 1) * (2 * rc + 1)) - (float)n_land, 1.0f);
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

// One tile: every cell's outputs, or (no coastal cell) the pass-through.
template <int MODE, int HS, int VS>
__device__ void run_tile(const Fields& f, const Scalars& s, int r0, int c0) {
  const int x = c0 + threadIdx.x % TW, y = r0 + threadIdx.x / TW;
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

  float n_thc;
  if constexpr (HS == 0)
    n_thc = ring_thc_tile_large(f, s, r0, c0, coastal, cdc);
  else
    n_thc = ring_thc_tile<HS, VS>(f, s, r0, c0, coastal, cdc);
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

// Up to 64 tiles' ever-coastal flags, from `first` on: bit i for tile
// first + i.  Sixteen mask bytes a load where they lie inside the mask and
// it is 16-byte aligned, so every load is in flight at once.
__device__ unsigned long long ever_bits(const unsigned char* ever, int first,
                                        int count, int ntiles) {
  const bool vec = (reinterpret_cast<uintptr_t>(ever) & 15) == 0;
  unsigned long long bits = 0;
  for (int q = 0; q < count; q += 16) {
    const int t = first + q;
    if (vec && q + 16 <= count && t + 16 <= ntiles) {
      const uint4 v = *reinterpret_cast<const uint4*>(ever + t);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((w[i / 4] >> (8 * (i % 4))) & 0xffu) bits |= 1ull << (q + i);
    } else {
      for (int i = 0; i < 16 && q + i < count && t + i < ntiles; ++i)
        if (ever[t + i]) bits |= 1ull << (q + i);
    }
  }
  return bits;
}

// B4 and B5: one block per tile.  B1, persistent: the ever-coastal tiles,
// in tile order, are dealt round-robin over the G = gridDim.x blocks by
// their rank among them: block b runs ranks b, b + G, b + 2G, ...  Every
// block ranks them itself: each thread reads the flags of a run of up to
// 64 tiles at once, a block scan of the runs' counts gives the ranks.  No
// list leaves the block and no atomic is needed; coastal tiles cluster,
// and dealing by rank, not by tile index, spreads each cluster evenly.
template <int MODE, int HS, int VS>
__global__ void __launch_bounds__(NT, HS >= 1 && HS <= 4 ? 2 : 1)
ring_kernel(const Fields f, const Scalars s) {
  __shared__ int s_list[NT];
  __shared__ int s_warp[NWARP];
  const int nj = (s.w + TW - 1) / TW;
  const int ntiles = nj * ((s.h + TH - 1) / TH);
  if (MODE != STACKED) {
    const int tile = blockIdx.x;
    run_tile<MODE, HS, VS>(f, s, (tile / nj) * TH, (tile % nj) * TW);
    return;
  }
  const int G = gridDim.x, b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  int base = 0;  // ever-coastal tiles before this round
  for (int c0 = 0; c0 < ntiles; c0 += NT * RUN) {
    // this thread's run: a multiple of 16 tiles, so its loads are aligned
    const int n = min(ntiles - c0, NT * RUN);
    const int per = ((n + NT - 1) / NT + 15) / 16 * 16;
    const int first = c0 + threadIdx.x * per;
    const unsigned long long bits =
        first < ntiles ? ever_bits(f.ever, first, per, ntiles) : 0ull;
    // exclusive scan of the runs' counts over the block
    const int cnt = __popcll(bits);
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    int off = inc - cnt, count = 0;
    for (int k = 0; k < NWARP; ++k) {
      off += k < warp ? s_warp[k] : 0;
      count += s_warp[k];
    }
    // this block's ordinals in the round: ranks in [base, base + count)
    // congruent to b, the ordinal of rank r being (r - b) / G.  A round
    // spans NT * RUN tiles, so s_list holds a block's share while
    // G >= RUN or G covers every tile (the launcher refuses other grids).
    const int o0 = (max(base - b, 0) + G - 1) / G;
    const int o1 = (max(base + count - b, 0) + G - 1) / G;
    int rank = base + off;
    for (unsigned long long m = bits; m; m &= m - 1, ++rank)
      if (rank % G == b)
        s_list[(rank - b) / G - o0] = first + __ffsll((long long)m) - 1;
    __syncthreads();
    for (int k = 0; k < o1 - o0; ++k) {
      const int tile = s_list[k];
      run_tile<MODE, HS, VS>(f, s, (tile / nj) * TH, (tile % nj) * TW);
    }
    base += count;
    __syncthreads();  // the list and counts are read before they change
  }
}

// One build's launch configuration at one radius on one device: the
// buffers of running sums (2 where they fit a block's shared memory, else
// 1), its shared memory, and the blocks the card holds at once.
struct Config {
  int dev = -1, nn = -1, nbuf = 0, resident = 0;
  size_t smem = 0;
};

// The launch of one build over the tiles of an (h, w) field: B1 on its
// persistent grid (the blocks the card holds at once, at most one per
// tile), B4 and B5 one block per tile.  The configuration is worked out
// at the first launch at a radius and kept, so a launch at the radius of
// the one before costs no driver query.  Returns 0, or the refusal of the
// shared memory (and clears it, so the next launch does not read it back
// as its own).
template <int MODE, int HS, int VS>
int launch_build(const Fields& f, Scalars s, cudaStream_t st) {
  auto kernel = ring_kernel<MODE, HS, VS>;
  static Config c;
  int dev = 0;
  cudaGetDevice(&dev);
  if (c.dev != dev || c.nn != s.nn) {
    cudaError_t err = cudaSuccess;
    int per_sm = 0, nbuf = 2;
    size_t smem = 0;
    for (; nbuf >= 1; --nbuf) {
      smem = HS == 0 ? smem_bytes_large(s.nn, nbuf) : smem_bytes(s.nn, nbuf);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            NT, smem);
      if (err == cudaSuccess && per_sm < 1)
        err = cudaErrorInvalidConfiguration;
      if (err == cudaSuccess) break;
      cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    c = Config{dev, s.nn, nbuf, per_sm * sms, smem};
  }
  s.nbuf = c.nbuf;
  const int ntiles = ((s.w + TW - 1) / TW) * ((s.h + TH - 1) / TH);
  const int grid =
      MODE == STACKED && c.resident < ntiles ? c.resident : ntiles;
  // B1's s_list holds a block's share of a round only where G >= RUN
  if (grid < ntiles && grid < RUN) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, NT, c.smem, st>>>(f, s);
  return (int)cudaGetLastError();
}

// The elements of hp ((TH+2NN) x TW) and vc (TH x (TW+2NN)) per thread
// decide the build below LARGE_FROM: NN <= 24 owns at most 4 and 3, NN <=
// 64 9 and 5 (whose strip fits an H100's 227 KB a block up to NN = 57).
// From LARGE_FROM to MAX_NN the large build; beyond, a refusal.
template <int MODE>
int launch(const Fields& f, const Scalars& s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.nn > MAX_NN) return (int)cudaErrorInvalidValue;
  if (s.nn >= LARGE_FROM) return launch_build<MODE, 0, 0>(f, s, st);
  if (s.nn <= 24) return launch_build<MODE, 4, 3>(f, s, st);
  if (s.nn <= 64) return launch_build<MODE, 9, 5>(f, s, st);
  return (int)cudaErrorInvalidValue;
}

Scalars make_scalars(int h, int w, int nn, int is_first, int upd,
                     int row_offset, int nlat_total, int skip_last_row,
                     float maxdist, float thresh_wind, float thresh_winddir,
                     float thresh_windch, float thresh_thc) {
  return Scalars{h, w, nn, is_first, upd, row_offset,
                 skip_last_row ? nlat_total - 1 : nlat_total, 2,
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

// The ring radii the launchers take: the large build from *large_from,
// every build up to *max_nn.  Returns 0.
extern "C" int sbz_ring_limits(int* large_from, int* max_nn) {
  *large_from = LARGE_FROM;
  *max_nn = MAX_NN;
  return 0;
}
