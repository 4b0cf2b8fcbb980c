// Kernels B1, B4 and B5, a design of the sweep build (NN past 2047) that
// lost: the first one measured, kept for tools/compare_designs.py
// (build `sweep_first`).  Everything but the sweep build is the port's
// csrc/ring_trigger.cu as it was then; the sweep build differs from the
// port's in three ways:
// * each hp warp stages the 156 cells a side of every 32-order chunk anew
//   (no ring: ~5x the loads, most of them cells the chunk before had);
// * a vc warp of 8 field rows loads its own column cells, 16 orders at a
//   time, each cell formed by a load that waits on its bounds check (the
//   8 row groups of 32 columns each load the same cells: ~8x the padded
//   field through L2), so a chunk's loads do not overlap;
// * a window takes one radius's four values at a time.
// Measured with tools/compare_designs.py on an NVIDIA H100 80GB HBM3 at
// 700 W (64 x 128 land): B1 3703.5 / 4233.5 us at NN = 2048 / 2204, the
// port's 1740.0 / 1977.8 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// threshold (-DSBZ_RING_LARGE_FROM=1); the port builds it at 52, the
// first radius of those timed at 0.1 deg (40, 44, 48, 52, 57) at which it
// beat <9,5> (PERF.md).
#ifndef SBZ_RING_LARGE_FROM
#define SBZ_RING_LARGE_FROM 52
#endif
constexpr int LARGE_FROM = SBZ_RING_LARGE_FROM;
// The widest radius whose window's cell count is below 2^24, exact in
// float32, and the widest radius the int32 integral image of land holds:
// (2 MAX_NN + 1)^2 <= 2^31 - 1.
constexpr int EXACT_NN = 2047;
constexpr int MAX_NN = 23169;
constexpr long long MAX_IMAGE_CELLS = 2147483647LL;

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
  int* land_ii;         // the large and sweep builds: their scratch, the
                        // integral image first
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

// The large build's bookkeeping.  Its radii are swept in bands of BAND.
// A window reads an hp row during TH consecutive radii and a vc column
// during TW, so a band reads HSPAN rows and VSPAN columns on each side
// (top / bottom, left / right).  Each is carried, in a register of its
// owner thread, from the band in which a window first reads it to the band
// in which one last does, in a slot of its side: row NN + d in slot
// d mod HSLOT, column NN + d in slot d mod VSLOT.  The BAND rows (columns)
// that enter a band take the slots of those that left the band before, an
// aligned block of BAND slots.
constexpr int BAND = TH;
constexpr int HSPAN = BAND + TH - 1, VSPAN = BAND + TW - 1;
constexpr int HSLOT = 32, VSLOT = 48;
// A warp's staged strip cells per piece: 32 orders of an hp chain need 63.
constexpr int PIECE = 64;
// A band's corner squares: the strip cells its radii add to the live
// elements, rows [a, a + SQH) or [b - 1, b - 1 + SQH) by columns [a, a +
// SQW) or [b, b + SQW), a = NN - n1 and b = NN + n0 for the band's radii
// n0..n1 (hp rows read 47 columns, vc columns 31 rows on each side).
constexpr int SQH = 32, SQW = 48, SQ = SQH * SQW;
// The entering vc columns' staged cells: 32 orders read 47 rows above the
// tile's centre row and 47 below, 48 each.
constexpr int VCH = 48;

// The large build's shared memory, at any radius: two buffers of the
// published hp slots (2 sides x HSLOT x TW) and vc slots (2 sides x TH x
// VSLOT), each warp's two pieces of staged strip cells, a band's four
// corner squares, and 2 x VCH rows of the entering vc columns' cells, all
// float2 (tl, ts): 144 KB.
size_t smem_bytes_large() {
  return sizeof(float2) *
         (2 * (2 * HSLOT * TW + 2 * TH * VSLOT) + NWARP * 2 * PIECE + 4 * SQ +
          2 * VCH * TW);
}

// The element in slot j of a side during the band from radius n0: its
// offset d from NN, whether the band carries it (inside the strip, whose
// rows (columns) run to NN + ext - 1 past NN), and whether it enters in
// this band, so that its chain starts from order 0.
struct Slot {
  int d;
  bool live, fresh;
};

template <int SPAN, int NSLOT>
__device__ __forceinline__ Slot band_slot(int side, int j, int n0, int NN,
                                          int ext) {
  if (side == 0) {  // top rows, left columns: d in [-n1, -n1 + SPAN)
    const int n1 = n0 + BAND - 1;
    const int q = (j + n1) % NSLOT;
    return Slot{q - n1, q < SPAN && NN + q - n1 >= 0, n0 == 1 || q < BAND};
  }
  const int q = ((j - n0) % NSLOT + NSLOT) % NSLOT;  // d in [n0, n0 + SPAN)
  return Slot{n0 + q, q < SPAN && n0 + q < NN + ext,
              n0 == 1 || q >= SPAN - BAND};
}

// An hp element from order 0 to order m along its row, the 32 elements of
// the row being the lanes of one warp (lane 0's centre at (gr, gc0 = gc -
// lane)), from cells staged in the warp's shared memory `st` and formed
// once: per 32 orders [lo, hi] a left piece of columns gc0 - hi .. gc0 +
// 31 - lo and a right piece gc0 + lo .. gc0 + 31 + hi, each cell then
// serving every lane whose chain passes through it.
__device__ __forceinline__ float2 chain_row_staged(const Fields& f, int gr,
                                                   int gc, int m, int ph,
                                                   int pw, float2* st) {
  const int lane = threadIdx.x % 32, gc0 = gc - lane;
  float2 v = strip_q(strip_load(f, gr, gc, ph, pw));
  for (int lo = 1; lo <= m; lo += 32) {
    const int hi = min(lo + 31, m);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      st[i] = strip_q(strip_load(f, gr, gc0 - hi + i, ph, pw));
      st[PIECE + i] = strip_q(strip_load(f, gr, gc0 + lo + i, ph, pw));
    }
    __syncwarp();
#pragma unroll 4
    for (int n = lo; n <= hi; ++n)
      add2(v, st[lane + hi - n], st[PIECE + lane + n - lo]);
  }
  return v;
}

__device__ __forceinline__ int mod_vslot(int x) {
  return (x % VSLOT + VSLOT) % VSLOT;
}

// Land cells of the window rows [y0, y1] x columns [x0, x1] of the padded
// field (y0, x0 inside it), from its integral image ii ((ph+1) x (pw+1));
// cells past the ragged edge are land, as the strip loads take them.
__device__ __forceinline__ int box_land(const int* ii, int ph, int pw,
                                        int y0, int x0, int y1, int x1) {
  const size_t W = pw + 1;
  const int ye = min(y1, ph - 1) + 1, xe = min(x1, pw - 1) + 1;
  const int in_land = __ldg(ii + ye * W + xe) - __ldg(ii + y0 * W + xe) -
                      __ldg(ii + ye * W + x0) + __ldg(ii + y0 * W + x0);
  return in_land + (y1 - y0 + 1) * (x1 - x0 + 1) - (ye - y0) * (xe - x0);
}

// The latch radius rc of the cell at (y, x) of the padded field (the first
// nn whose window holds both classes, else NN) and its land count there,
// from box counts of the launch's integral image of land ii: a binary search
// over the exact counts up to EXACT_NN (the condition only turns on as nn
// grows) and, with PAST, past it the plain version's float32 chain radius by
// radius from the exact count at EXACT_NN, the last radius taken being the
// latch.  Each of the chain's four terms is one row or column of the
// window, a whole number of at most 2 nn + 1 cells and so an exact box
// count.  The large build takes NN <= EXACT_NN only, so PAST false.
template <bool PAST>
__device__ __forceinline__ void cell_latch(const int* ii, int ph, int pw,
                                           int NN, int y, int x, int& rc,
                                           float& lat_nl) {
  auto box = [&](int y0, int x0, int y1, int x1) {
    return box_land(ii, ph, pw, y0, x0, y1, x1);
  };
  auto count = [&](int nn) { return box(y - nn, x - nn, y + nn, x + nn); };
  auto both = [](int nn, int c) {
    return c > 0 && c < (2 * nn + 1) * (2 * nn + 1);
  };
  const int exact = min(NN, EXACT_NN);
  int n_land = count(exact);
  int lo = 1, hi = exact;
  const bool found = both(exact, n_land);
  if (found) {
    while (lo < hi) {
      const int mid = (lo + hi) / 2, c = count(mid);
      if (both(mid, c)) {
        hi = mid;
        n_land = c;
      } else {
        lo = mid + 1;
      }
    }
  }
  rc = hi;
  lat_nl = (float)n_land;
  if (!PAST || found) return;
  // four radii's box counts loaded at once, then taken in order
  for (int n0 = exact + 1; n0 <= NN; n0 += 4) {
    float tb[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nn = min(n0 + q, NN);
      tb[q][0] = (float)box(y - nn, x - nn, y - nn, x + nn);
      tb[q][1] = (float)box(y + nn, x - nn, y + nn, x + nn);
      tb[q][2] = (float)box(y - nn + 1, x - nn, y + nn - 1, x - nn);
      tb[q][3] = (float)box(y - nn + 1, x + nn, y + nn - 1, x + nn);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nn = n0 + q;
      if (nn > NN) return;
      lat_nl = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(lat_nl, tb[q][0]), tb[q][1]),
                    tb[q][2]),
          tb[q][3]);
      rc = nn;
      if (lat_nl > 0.0f &&
          __fsub_rn((float)((2 * nn + 1) * (2 * nn + 1)), lat_nl) > 0.0f)
        return;
    }
  }
}

// The large build's ring search of the tile at (r0, c0) (NN >= LARGE_FROM),
// run by every thread of the block; the same n_thc, bit for bit, as
// ring_thc_tile.  Each coastal cell first finds its latch radius rc (the
// first window holding both classes, else NN) and its land count there by
// a binary search over box counts of the launch's integral image of land
// (whole numbers, exact: the build takes NN up to EXACT_NN), so the tile
// knows its radii R, those of its slowest cell, before the sweep and the
// sums carry (tl, ts) only.  Thread
// (ty, tx) owns hp slots ty and ty + 16 of each side at column tx, and vc
// slots of row ty: lanes 0-15 three of the left side's, lanes 16-31 three
// of the right side's, paired so that the blocks entering a band are one
// of the three for every thread.  At the start of a band the entering
// elements run their chains; then per radius nn each thread takes its live
// hp elements to order nn and its vc elements to order nn-1, and publishes
// those a window reads at nn into buffer nn & 1; one barrier; then each
// cell's window, up to its latch radius.
__device__ float ring_thc_tile_large(const Fields& f, const Scalars& s,
                                     int r0, int c0, bool coastal,
                                     float cdc) {
  __shared__ int s_rmax[NWARP];
  constexpr int HN = 2 * HSLOT * TW, VN = 2 * TH * VSLOT;  // one buffer
  const int NN = s.nn;
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int half = tx / 16;  // the vc side of this lane

  int rc = 0;
  float lat_nl = 0.0f;  // the land count at rc
  if (coastal)
    cell_latch<false>(f.land_ii, ph, pw, NN, r0 + ty + NN, c0 + tx + NN, rc,
                      lat_nl);
  const int wmax = __reduce_max_sync(0xffffffffu, rc);
  if (tx == 0) s_rmax[ty] = wmax;
  __syncthreads();
  int R = 0;
  for (int k = 0; k < NWARP; ++k) R = max(R, s_rmax[k]);

  extern __shared__ float2 smem2[];
  float2* s_sum = smem2;  // 2 x (hp (side, slot, tx), vc (side, ty, slot))
  float2* st = s_sum + 2 * (HN + VN) + ty * 2 * PIECE;  // this warp's cells
  float2* sq = s_sum + 2 * (HN + VN) + NWARP * 2 * PIECE;  // the 4 squares
  float2* vs = sq + 4 * SQ;  // the entering vc columns' cells
  float2 hv[4], vv[3];
  int hd[4], vd[3], vslot[3];
  bool hlive[4], vlive[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    vslot[k] = 16 * (half == 0 ? k : (4 - k) % 3) + tx % 16;

  float2 W = strip_q(strip_load(f, r0 + ty + NN, c0 + tx + NN, ph, pw));
  float lat_tl = 0.0f, lat_ts = 0.0f;
  for (int n0 = 1; n0 <= R; n0 += BAND) {
    const int n1 = n0 + BAND - 1;
    // the band's corner squares (top-left, top-right, bottom-left,
    // bottom-right), formed once; the last radius of the band before read
    // the old ones before its barrier
    for (int i = threadIdx.x; i < 4 * SQ; i += NT) {
      const int q = i / SQ, rr = (i % SQ) / SQW, cc = i % SQW;
      const int r = (q < 2 ? NN - n1 : NN + n0 - 1) + rr;
      const int c = (q % 2 == 0 ? NN - n1 : NN + n0) + cc;
      sq[i] = r >= 0 && c >= 0
                  ? strip_q(strip_load(f, r0 + r, c0 + c, ph, pw))
                  : make_float2(0.0f, 0.0f);  // never read
    }
    // the band's elements; those entering it run their chains to the
    // orders its first radius advances from: hp n0-1, vc n0-2
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Slot sl =
          band_slot<HSPAN, HSLOT>(k / 2, 16 * (k % 2) + ty, n0, NN, TH);
      hd[k] = sl.d;
      hlive[k] = sl.live;
      if (sl.live && sl.fresh)  // the same for the whole warp
        hv[k] = chain_row_staged(f, r0 + NN + sl.d, c0 + NN + tx, n0 - 1,
                                 ph, pw, st);
    }
    // vc: those entering run from their centre cell ...
    int kf = 0;
    bool live_f = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Slot sl = band_slot<VSPAN, VSLOT>(half, vslot[k], n0, NN, TW);
      vd[k] = sl.d;
      vlive[k] = sl.live;
      if (sl.live && sl.fresh) {
        vv[k] = strip_q(strip_load(f, r0 + NN + ty, c0 + NN + sl.d, ph, pw));
        kf = k;
        live_f = true;
      }
    }
    // ... and from n0 = 17 on, the entering ones are one block of slots for
    // every thread, 16 columns a side (lane tx: column NN - n1 + tx, or NN +
    // n0 + 31 + tx - 16); their chains to order n0 - 2 run together, from
    // cells of those columns staged 32 orders at a time
    if (n0 > 1) {
      float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == kf) v = vv[k];
      for (int lo = 1; lo <= n0 - 2; lo += 32) {
        const int hi = min(lo + 31, n0 - 2);
        __syncthreads();  // the cells before are read
        for (int i = threadIdx.x; i < 2 * VCH * TW; i += NT) {
          const int rr = (i / TW) % VCH, lc = i % TW;
          const int x = (lc < 16 ? NN - n1 : NN + n0 + 31) + lc % 16;
          const int y = (i < VCH * TW ? NN - hi : NN + lo) + rr;
          vs[i] = x >= 0 ? strip_q(strip_load(f, r0 + y, c0 + x, ph, pw))
                         : make_float2(0.0f, 0.0f);  // never read
        }
        __syncthreads();
        if (live_f)  // rows ty + NN -/+ n
          for (int n = lo; n <= hi; ++n)
            add2(v, vs[(ty + hi - n) * TW + tx],
                 vs[(VCH + ty + n - lo) * TW + tx]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == kf && live_f) vv[k] = v;
    }
    __syncthreads();  // the squares are in
    const int nend = min(n1, R);
    for (int nn = n0; nn <= nend; ++nn) {
      float2* sb = s_sum + (nn & 1) * (HN + VN);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!hlive[k]) continue;
        // row NN + hd[k] of the top (bottom) squares, columns tx + NN -/+ nn
        const float2* row =
            sq + (k < 2 ? hd[k] + n1 : 2 * SQH + hd[k] - n0 + 1) * SQW;
        add2(hv[k], row[tx + n1 - nn], row[SQ + tx + nn - n0]);
        const int t = k < 2 ? hd[k] + nn : hd[k] - nn;  // the reading row
        if (t >= 0 && t < TH)
          sb[((k / 2) * HSLOT + 16 * (k % 2) + ty) * TW + tx] = hv[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (!vlive[k]) continue;
        if (nn > 1) {  // rows ty + NN -/+ (nn-1) of column NN + vd[k]
          const float2* col = sq + (half == 0 ? vd[k] + n1 : SQ + vd[k] - n0);
          add2(vv[k], col[(ty + n1 - nn + 1) * SQW],
               col[2 * SQ + (ty + nn - n0) * SQW]);
        }
        const int t = half == 0 ? vd[k] + nn : vd[k] - nn;  // the column
        if (t >= 0 && t < TW)
          sb[HN + (half * TH + ty) * VSLOT + vslot[k]] = vv[k];
      }
      __syncthreads();
      // window: two full-width rows (hp, order nn), two partial columns
      // (vc, order nn-1)
      if (nn <= rc) {
        const float2 top = sb[((ty - nn) & (HSLOT - 1)) * TW + tx];
        const float2 bot = sb[(HSLOT + ((ty + nn) & (HSLOT - 1))) * TW + tx];
        const float2 lft = sb[HN + ty * VSLOT + mod_vslot(tx - nn)];
        const float2 rgt = sb[HN + (TH + ty) * VSLOT + mod_vslot(tx + nn)];
        W.x = (((W.x + top.x) + bot.x) + lft.x) + rgt.x;
        W.y = (((W.y + top.y) + bot.y) + lft.y) + rgt.y;
        if (nn == rc) {
          lat_tl = W.x;
          lat_ts = W.y;
        }
      }
    }
  }
  // the latched means, as ring_thc_tile takes them (the sea count as the
  // plain version forms it: exact up to EXACT_NN, rounded past it)
  const float lat_ns =
      __fsub_rn((float)((2 * rc + 1) * (2 * rc + 1)), lat_nl);
  const float mul = cdc >= 0.0f ? 1.0f : -1.0f;
  return coastal ? mul * (lat_tl / fmaxf(lat_nl, 1.0f) -
                          lat_ts / fmaxf(lat_ns, 1.0f))
                 : 0.0f;
}

// The large build's integral image of land over the padded field, ii[i][j]
// the land cells of rows < i and columns < j, (ph+1) x (pw+1) ints in the
// caller's scratch: first each row's prefix, one warp a row ...
__global__ void land_rows(const float* cd_pad, int* ii, int ph, int pw) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const size_t W = pw + 1;
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < (int)W; j += blockDim.x) ii[j] = 0;
  if (r >= ph) return;
  int* out = ii + (r + 1) * W;
  if (lane == 0) out[0] = 0;
  int carry = 0;
  for (int c0 = 0; c0 < pw; c0 += 32) {
    const int c = c0 + lane;
    int v = c < pw && cd_pad[(size_t)r * pw + c] >= 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (c < pw) out[c + 1] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// ... then, in place, down each column: a block of 16 warps per 32 columns,
// each warp a run of rows (the runs' sums, a scan over them, the prefixes).
__global__ void land_cols(int* ii, int ph, int pw) {
  __shared__ int s_run[16][32];
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane + 1;
  const size_t W = pw + 1;
  const int per = (ph + 15) / 16;
  const int i0 = 1 + wp * per, i1 = min(ph + 1, i0 + per);
  int sum = 0;
  if (j <= pw)
    for (int i = i0; i < i1; ++i) sum += ii[i * W + j];
  s_run[wp][lane] = sum;
  __syncthreads();
  int carry = 0;
  for (int k = 0; k < wp; ++k) carry += s_run[k][lane];
  if (j <= pw)
    for (int i = i0; i < i1; ++i) {
      carry += ii[i * W + j];
      ii[i * W + j] = carry;
    }
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
  int nn = -1, nbuf = 0, resident = 0;
  size_t smem = 0;
};

// Launch configurations are kept per card: cudaFuncSetAttribute is a
// card's own, and a mesh over several cards alternates between them.
constexpr int kMaxDevices = 64;

// The launch of one build over the tiles of an (h, w) field: B1 on its
// persistent grid (the blocks the card holds at once, at most one per
// tile), B4 and B5 one block per tile.  The configuration is worked out
// at the first launch at a radius and kept, so a launch at the radius of
// the one before on that card costs no driver query.  Returns 0, or the
// refusal of the shared memory (and clears it, so the next launch does not
// read it back as its own).
template <int MODE, int HS, int VS>
int launch_build(const Fields& f, Scalars s, cudaStream_t st) {
  auto kernel = ring_kernel<MODE, HS, VS>;
  static Config configs[kMaxDevices];
  Config spare;
  int dev = 0;
  cudaGetDevice(&dev);
  Config& c = dev < kMaxDevices ? configs[dev] : spare;
  if (c.nn != s.nn) {
    cudaError_t err = cudaSuccess;
    int per_sm = 0, nbuf = 2;
    size_t smem = 0;
    for (; nbuf >= 1; --nbuf) {
      smem = HS == 0 ? smem_bytes_large() : smem_bytes(s.nn, nbuf);
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
    c = Config{s.nn, nbuf, per_sm * sms, smem};
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

// ---------------------------------------------------------------------------
// The sweep build (NN >= SWEEP_FROM): every running-sum chain once per
// field, over the whole card (design notes in the file's header).

// The first NN of the sweep build, past EXACT_NN.  A build option only so
// that tools/compare_designs.py can time it at the large build's radii
// (-DSBZ_RING_SWEEP_FROM=52); the large build takes NN <= EXACT_NN only.
#ifndef SBZ_RING_SWEEP_FROM
#define SBZ_RING_SWEEP_FROM (EXACT_NN + 1)
#endif
constexpr int SWEEP_FROM = SBZ_RING_SWEEP_FROM;
static_assert(SWEEP_FROM <= EXACT_NN + 1,
              "the large build counts land exactly, up to EXACT_NN only");

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// hp columns a lane and vc rows a lane; the orders a warp stages at once
// for its hp chains (a multiple of HC) and a lane for its vc chains (a
// multiple of VR).
constexpr int HC = 4, VR = 8, HCHUNK = 32, VCHUNK = 16;
// A warp's staged hp cells a side, (WARP - 1) HC + HCHUNK, skewed one
// float2 every HC so that lanes HC apart take different banks.
constexpr int HSPAN_W = (WARP - 1) * HC + HCHUNK;
constexpr int HSTAGE = HSPAN_W + HSPAN_W / HC + 1;
constexpr int STAGE = 2 * HSTAGE > 2 * VCHUNK * WARP ? 2 * HSTAGE
                                                    : 2 * VCHUNK * WARP;
constexpr int SWEEP_NT = 128, SWEEP_WARPS = SWEEP_NT / WARP;
// The band of radii: the widest of 64, 32, 16, 8 whose two buffers fit
// SWEEP_BAND_BYTES (else 8).
constexpr long long SWEEP_BAND_BYTES = 128LL << 20;
constexpr int SWEEP_BAND_MAX = 64, SWEEP_BAND_MIN = 8;

bool takes_sweep(int nn) { return nn >= LARGE_FROM && nn >= SWEEP_FROM; }

// The sweep's scratch past the integral image, offsets in ints: the
// launch's widest latch radius per column, per row and overall; each cell's
// latch radius, land count and window sums; the hp and vc elements' states
// ((h + 2NN) x w and h x (w + 2NN) float2); two band buffers of (4
// directions, band radii, h rows, wb columns) float2, wb = w rounded up to
// 4 so that a lane's HC values are two aligned float4.
struct SweepLayout {
  int band, nb, wb;
  long long hdr, rc, nl, W, hps, vcs, buf, total;
};

SweepLayout sweep_layout(int h, int w, int nn) {
  SweepLayout L;
  const long long cells = (long long)h * w;
  L.wb = (w + 3) / 4 * 4;
  L.band = SWEEP_BAND_MAX;
  while (L.band > SWEEP_BAND_MIN &&
         2LL * 4 * L.band * h * L.wb * 8 > SWEEP_BAND_BYTES)
    L.band /= 2;
  L.nb = (nn + L.band - 1) / L.band;
  auto up4 = [](long long x) { return (x + 3) / 4 * 4; };
  long long o = (long long)(h + 2 * nn + 1) * (w + 2 * nn + 1);
  L.hdr = up4(o);
  L.rc = up4(L.hdr + w + h + 1);
  L.nl = L.rc + cells;
  L.W = up4(L.nl + cells);
  L.hps = L.W + 2 * cells;
  L.vcs = L.hps + 2LL * (h + 2 * nn) * w;
  L.buf = up4(L.vcs + 2LL * h * (w + 2 * nn));
  L.total = L.buf + 2LL * 2 * 4 * L.band * h * L.wb;
  return L;
}

struct SweepArgs {
  int* Rcol;  // (w) the widest latch radius of each field column
  int* Rrow;  // (h) of each field row
  int* Rmax;  // (1) of the launch
  int* rc;    // (h, w) each cell's latch radius, 0 where it does not run
  float* nl;  // (h, w) its land count at rc
  float2* W;  // (h, w) its window sums (tl, ts), latched at rc
  float2* hps;  // (h + 2NN, w) hp elements at their current order
  float2* vcs;  // (h, w + 2NN) vc elements
  float2* buf;  // the two band buffers
  int band, wb;
};

// The warps of one launch: hp rows d = dlo..dhi off each side of the field
// (padded rows NN - d and NN + h - 1 + d), then the field's own rows when
// mid_h, each over column groups of WARP x HC; vc groups j = jhi..jlo each
// side (lanes at padded columns NN - (1 + 32 j + lane) and NN + w + 32 j +
// lane), then the field's own columns when mid_v, each over row groups of
// VR.  The longest chains come first.
struct Warps {
  int dlo, dhi, mid_h, jlo, jhi, mid_v, n_hp, n_vc;
};

// The catch-up's warps (all), or those of the band [n0, n1]: the rows and
// columns whose windows' radii meet the band.
Warps sweep_warps(int h, int w, int nn, int n0, int n1, bool all) {
  Warps k;
  if (all) {
    k = Warps{1, nn, 1, 0, (nn - 1) / WARP, 1, 0, 0};
  } else {
    k.dlo = std::max(1, n0 - h + 1);
    k.dhi = std::min(n1, nn);
    k.mid_h = n0 <= h - 1;
    k.jlo = n0 - w - (WARP - 1) > 0 ? (n0 - w) / WARP : 0;
    k.jhi = std::min((n1 - 1) / WARP, (nn - 1) / WARP);
    k.mid_v = n0 <= w - 1;
  }
  const int ncg = (w + WARP * HC - 1) / (WARP * HC), nyg = (h + VR - 1) / VR;
  const int nd = std::max(0, k.dhi - k.dlo + 1);
  const int nj = std::max(0, k.jhi - k.jlo + 1);
  k.n_hp = (2 * nd + (k.mid_h ? h : 0)) * ncg;
  k.n_vc = (2 * nj + (k.mid_v ? (w + WARP - 1) / WARP : 0)) * nyg;
  return k;
}

// The least and greatest radius at which a window of a field axis n long
// reads the element at offset e off the field's first row (hp, n = h) or
// column (vc, n = w).
__device__ __forceinline__ int first_radius(int e, int n) {
  return e < 0 ? -e : (e >= n ? e - n + 1 : 1);
}
__device__ __forceinline__ int last_radius(int e, int n, int NN) {
  return min(max(n - 1 - e, e), NN);
}

// A cell of the padded field as the strip loads form it; (0, 0) outside.
__device__ __forceinline__ float2 cell_q(const Fields& f, int gr, int gc,
                                         int ph, int pw) {
  if (gr < 0 || gc < 0 || gr >= ph || gc >= pw)
    return make_float2(0.0f, 0.0f);
  const size_t i = (size_t)gr * pw + gc;
  return strip_q(StripCell{__ldg(f.t0_pad + i), __ldg(f.cd_pad + i)});
}

// One warp's hp chains from order so to order t: lane l's HC elements at
// padded columns cb + i (cb = cw + l HC) of padded row r, in v.  Each lane
// keeps the cells of its elements' left and right terms in two register
// windows of HC slots: the left window holds positions cb + m - k, the
// right cb + m + k (m < HC), position m in slot (m -/+ (k - so)) mod HC, so
// that an order takes one new cell a side and the slots are static within
// the unrolled chunk.  Every HCHUNK orders the warp stages the cells its
// windows take next, HSPAN_W a side, formed once, in its shared memory
// `st`.  emit(k, v) after each order.
template <class Emit>
__device__ __forceinline__ void hp_run(const Fields& f, int r, int cw, int so,
                                       int t, int ph, int pw,
                                       float2 (&v)[HC], float2* st,
                                       Emit&& emit) {
  const int lane = threadIdx.x % WARP, cb = cw + lane * HC;
  float2 lw[HC], rw[HC];
#pragma unroll
  for (int m = 0; m < HC; ++m) {
    lw[m] = cell_q(f, r, cb + m - so, ph, pw);
    rw[m] = cell_q(f, r, cb + m + so, ph, pw);
  }
  float2* sl = st;
  float2* sr = st + HSTAGE;
  for (int kc = so + 1; kc <= t; kc += HCHUNK) {
    __syncwarp();  // the cells before are read
    for (int u = lane; u < HSPAN_W; u += WARP) {
      sl[u + u / HC] = cell_q(f, r, cw - kc - HCHUNK + 1 + u, ph, pw);
      sr[u + u / HC] = cell_q(f, r, cw + HC - 1 + kc + u, ph, pw);
    }
    __syncwarp();
    // lane l's cells: u = l HC + c sits at l (HC + 1) + c + c / HC
    const float2* l0 = sl + lane * (HC + 1);
    const float2* r0 = sr + lane * (HC + 1);
#pragma unroll
    for (int s = 0; s < HCHUNK; ++s) {
      if (kc + s > t) break;
      const int cl = HCHUNK - 1 - s;
      lw[HC - 1 - s % HC] = l0[cl + cl / HC];
      rw[s % HC] = r0[s + s / HC];
#pragma unroll
      for (int i = 0; i < HC; ++i)
        add2(v[i], lw[(i + HC - 1 - s % HC) % HC], rw[(i + 1 + s) % HC]);
      emit(kc + s, v);
    }
  }
}

// One lane's vc chains from order so to order t: its VR elements at field
// rows y0 + i (padded rows r0 + i) of padded column pc, in u; register
// windows as hp_run's (up: rows r0 + m - j, down: r0 + m + j).  Every
// VCHUNK orders the lane stages the cells it takes next in its own shared
// memory, `st` (stride WARP), so that their loads are in flight together.
template <class Emit>
__device__ __forceinline__ void vc_run(const Fields& f, int r0, int pc, int so,
                                       int t, int ph, int pw,
                                       float2 (&u)[VR], float2* st,
                                       Emit&& emit) {
  float2 upw[VR], dnw[VR];
#pragma unroll
  for (int m = 0; m < VR; ++m) {
    upw[m] = cell_q(f, r0 + m - so, pc, ph, pw);
    dnw[m] = cell_q(f, r0 + m + so, pc, ph, pw);
  }
  for (int jc = so + 1; jc <= t; jc += VCHUNK) {
#pragma unroll
    for (int s = 0; s < VCHUNK; ++s) {
      st[s * WARP] = cell_q(f, r0 - jc - s, pc, ph, pw);
      st[(VCHUNK + s) * WARP] = cell_q(f, r0 + VR - 1 + jc + s, pc, ph, pw);
    }
#pragma unroll
    for (int s = 0; s < VCHUNK; ++s) {
      if (jc + s > t) break;
      upw[VR - 1 - s % VR] = st[s * WARP];
      dnw[s % VR] = st[(VCHUNK + s) * WARP];
#pragma unroll
      for (int i = 0; i < VR; ++i)
        add2(u[i], upw[(i + VR - 1 - s % VR) % VR], dnw[(i + 1 + s) % VR]);
      emit(jc + s, u);
    }
  }
}

// Row y of direction dir (0 top, 1 bottom, 2 left, 3 right) at radius n0 +
// kk in band buffer pb.
__device__ __forceinline__ float2* band_row(const SweepArgs& a, int h, int pb,
                                            int dir, int kk, int y) {
  return a.buf + ((((size_t)pb * 4 + dir) * a.band + kk) * h + y) * a.wb;
}

// The hp warp `item` of launch k: in the catch-up (BAND false) its elements
// from order 0 to the order before their first read; in band [n0, n1]
// (buffer pb) from the state to the band's last order they are read at,
// writing each value a window of the band reads.  The warp's elements run
// to the widest latch radius of its columns.
template <bool IN_BAND>
__device__ void hp_warp(const Fields& f, const Scalars& s, const SweepArgs& a,
                        const Warps& k, int item, int n0, int n1, int pb,
                        float2* st) {
  const int NN = s.nn, ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const int ncg = (s.w + WARP * HC - 1) / (WARP * HC);
  const int rank = item / ncg, cg = item % ncg;
  const int nd = max(0, k.dhi - k.dlo + 1);
  const int e = rank < 2 * nd ? (rank % 2 == 0 ? -(k.dhi - rank / 2)
                                               : s.h - 1 + k.dhi - rank / 2)
                              : rank - 2 * nd;
  const int x0 = cg * WARP * HC + (threadIdx.x % WARP) * HC;
  int gR = 0;
#pragma unroll
  for (int i = 0; i < HC; ++i)
    if (x0 + i < s.w) gR = max(gR, a.Rcol[x0 + i]);
  gR = __reduce_max_sync(FULL, gR);
  const int kmin = first_radius(e, s.h);
  const int kmax = min(last_radius(e, s.h, NN), gR);
  const int fr = IN_BAND ? max(kmin, n0) : 1;
  const int to = IN_BAND ? min(kmax, n1) : kmin - 1;
  if ((IN_BAND ? fr : kmin) > (IN_BAND ? to : kmax)) return;
  const int r = NN + e;
  float2* hs = a.hps + (size_t)r * s.w;
  float2 v[HC];
#pragma unroll
  for (int i = 0; i < HC; ++i)
    v[i] = !IN_BAND ? cell_q(f, r, NN + x0 + i, ph, pw)
                 : (x0 + i < s.w ? hs[x0 + i] : make_float2(0.0f, 0.0f));
  hp_run(f, r, NN + cg * WARP * HC, IN_BAND ? fr - 1 : 0, to, ph, pw, v, st,
         [&](int kk, const float2(&v)[HC]) {
           if (!IN_BAND) return;
           const int ys[2] = {e + kk, e - kk};  // top, bottom reader rows
#pragma unroll
           for (int d = 0; d < 2; ++d) {
             if (ys[d] < 0 || ys[d] >= s.h) continue;
             float2* row = band_row(a, s.h, pb, d, kk - n0, ys[d]);
#pragma unroll
             for (int p = 0; p < HC; p += 2)
               if (x0 + p < s.w)
                 *reinterpret_cast<float4*>(row + x0 + p) =
                     make_float4(v[p].x, v[p].y, v[p + 1].x, v[p + 1].y);
           }
         });
#pragma unroll
  for (int i = 0; i < HC; ++i)
    if (x0 + i < s.w) hs[x0 + i] = v[i];
}

// The vc warp `item` of launch k: its group's 32 padded columns at VR field
// rows, as hp_warp.  The lanes' first radii differ, so the warp runs from
// the least, to the greatest last radius of its lanes (at most the widest
// latch radius of its rows); a value no window reads is not written.
template <bool IN_BAND>
__device__ void vc_warp(const Fields& f, const Scalars& s, const SweepArgs& a,
                        const Warps& k, int item, int n0, int n1, int pb,
                        float2* st) {
  const int NN = s.nn, ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const int lane = threadIdx.x % WARP;
  const int nyg = (s.h + VR - 1) / VR;
  const int gi = item / nyg, y0 = (item % nyg) * VR;
  const int nj = max(0, k.jhi - k.jlo + 1);
  int ep, lo, hi;  // this lane's column offset and its group's side
  if (gi < 2 * nj) {
    const int d0 = 1 + WARP * (k.jhi - gi / 2);
    if (gi % 2 == 0) {
      ep = -(d0 + lane), lo = -NN, hi = -1;
    } else {
      ep = s.w - 1 + d0 + lane, lo = s.w, hi = s.w + NN - 1;
    }
  } else {
    ep = WARP * (gi - 2 * nj) + lane, lo = 0, hi = s.w - 1;
  }
  const bool eok = ep >= lo && ep <= hi;
  int gR = 0;
#pragma unroll
  for (int i = 0; i < VR; ++i)
    if (y0 + i < s.h) gR = max(gR, a.Rrow[y0 + i]);
  const int nmin = __reduce_min_sync(FULL, eok ? first_radius(ep, s.w)
                                               : 0x7fffffff);
  const int nmax = __reduce_max_sync(
      FULL, eok ? min(last_radius(ep, s.w, NN), gR) : 0);
  if (nmin > nmax) return;
  int so, to, fr = 0;
  if (IN_BAND) {
    fr = max(nmin, n0);
    to = min(nmax, n1);
    if (fr > to) return;
    so = fr == nmin ? max(nmin - 2, 0) : n0 - 2;
    to -= 1;  // the order of radius `to`
  } else {
    so = 0;
    to = max(nmin - 2, 0);
  }
  const int pc = NN + ep, vw = s.w + 2 * NN;
  float2 u[VR];
#pragma unroll
  for (int i = 0; i < VR; ++i)
    u[i] = !IN_BAND ? cell_q(f, NN + y0 + i, pc, ph, pw)
                 : (eok && y0 + i < s.h ? a.vcs[(size_t)(y0 + i) * vw + pc]
                                        : make_float2(0.0f, 0.0f));
  auto emit = [&](int j, const float2(&u)[VR]) {
    if (!IN_BAND || !eok) return;
    const int nn = j + 1, xs[2] = {ep + nn, ep - nn};  // left, right readers
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (xs[d] < 0 || xs[d] >= s.w) continue;
#pragma unroll
      for (int i = 0; i < VR; ++i)
        if (y0 + i < s.h)
          band_row(a, s.h, pb, 2 + d, nn - n0, y0 + i)[xs[d]] = u[i];
    }
  };
  if (IN_BAND && fr - 1 == so) emit(so, u);  // order 0 at radius 1
  vc_run(f, NN + y0, pc, so, to, ph, pw, u, st + lane, emit);
  if (eok)
#pragma unroll
    for (int i = 0; i < VR; ++i)
      if (y0 + i < s.h) a.vcs[(size_t)(y0 + i) * vw + pc] = u[i];
}

// 1. Each cell that runs (within maxdist; for B1 in an ever-coastal tile):
// its latch radius, land count and order-0 window; the launch's widest
// latch radius per column, per row and overall.
template <int MODE>
__global__ void __launch_bounds__(SWEEP_NT)
sweep_latch(const Fields f, const Scalars s, const SweepArgs a) {
  const int NN = s.nn, ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const long long cells = (long long)s.h * s.w;
  const long long c = (long long)blockIdx.x * SWEEP_NT + threadIdx.x;
  const bool inside = c < cells;
  const int y = inside ? (int)(c / s.w) : -1, x = inside ? (int)(c % s.w) : 0;
  bool run = inside && fabsf(f.cd[inside ? c : 0]) <= s.maxdist;
  if (MODE == STACKED && run)
    run = f.ever[(y / TH) * ((s.w + TW - 1) / TW) + x / TW];
  int rc = 0;
  float nl = 0.0f;
  if (run) {
    cell_latch<true>(f.land_ii, ph, pw, NN, y + NN, x + NN, rc, nl);
    a.W[c] = cell_q(f, y + NN, x + NN, ph, pw);
    atomicMax(a.Rcol + x, rc);
  }
  if (inside) {
    a.rc[c] = rc;
    a.nl[c] = nl;
  }
  // the rows' and the launch's widest, one atomic per row segment of a warp
  const unsigned same = __match_any_sync(FULL, y);
  const int row_max = __reduce_max_sync(same, rc);
  if (inside && row_max > 0 &&
      (int)(threadIdx.x % WARP) == __ffs(same) - 1)
    atomicMax(a.Rrow + y, row_max);
  const int warp_max = __reduce_max_sync(FULL, rc);
  if (threadIdx.x % WARP == 0 && warp_max > 0) atomicMax(a.Rmax, warp_max);
}

// 2. The catch-up: every hp and vc warp of the launch from order 0.
__global__ void __launch_bounds__(SWEEP_NT)
sweep_catchup(const Fields f, const Scalars s, const SweepArgs a,
              const Warps k) {
  __shared__ float2 s_stage[SWEEP_WARPS][STAGE];
  const int wp = threadIdx.x / WARP;
  const long long g = (long long)blockIdx.x * SWEEP_WARPS + wp;
  if (g < k.n_hp)
    hp_warp<false>(f, s, a, k, (int)g, 0, 0, 0, s_stage[wp]);
  else if (g < (long long)k.n_hp + k.n_vc)
    vc_warp<false>(f, s, a, k, (int)(g - k.n_hp), 0, 0, 0, s_stage[wp]);
}

// 3. Band b: its hp and vc warps (blocks below wblocks; none past the
// last band or the launch's widest latch radius) into buffer b & 1, and
// each cell's window over band b - 1 from the other buffer (the blocks
// from wblocks on).
__global__ void __launch_bounds__(SWEEP_NT)
sweep_band(const Fields f, const Scalars s, const SweepArgs a, const Warps k,
           int b, int wblocks) {
  __shared__ float2 s_stage[SWEEP_WARPS][STAGE];
  const int NN = s.nn, R = *a.Rmax;
  if ((int)blockIdx.x < wblocks) {
    const int n0 = 1 + b * a.band, n1 = min(n0 + a.band - 1, NN);
    if (n0 > R) return;
    const int wp = threadIdx.x / WARP;
    const long long g = (long long)blockIdx.x * SWEEP_WARPS + wp;
    if (g < k.n_hp)
      hp_warp<true>(f, s, a, k, (int)g, n0, n1, b & 1, s_stage[wp]);
    else if (g < (long long)k.n_hp + k.n_vc)
      vc_warp<true>(f, s, a, k, (int)(g - k.n_hp), n0, n1, b & 1,
                    s_stage[wp]);
    return;
  }
  const int p0 = 1 + (b - 1) * a.band, p1 = min(p0 + a.band - 1, NN);
  const long long c =
      (long long)(blockIdx.x - wblocks) * SWEEP_NT + threadIdx.x;
  if (p0 > R || c >= (long long)s.h * s.w) return;
  const int rc = a.rc[c];
  if (rc < p0) return;
  const int y = (int)(c / s.w), x = (int)(c % s.w), pb = (b - 1) & 1;
  float2 W = a.W[c];
  const int end = min(p1, rc);
  for (int nn = p0; nn <= end; ++nn) {
    const float2 top = band_row(a, s.h, pb, 0, nn - p0, y)[x];
    const float2 bot = band_row(a, s.h, pb, 1, nn - p0, y)[x];
    const float2 lft = band_row(a, s.h, pb, 2, nn - p0, y)[x];
    const float2 rgt = band_row(a, s.h, pb, 3, nn - p0, y)[x];
    W.x = (((W.x + top.x) + bot.x) + lft.x) + rgt.x;
    W.y = (((W.y + top.y) + bot.y) + lft.y) + rgt.y;
  }
  a.W[c] = W;
}

// 4. Each cell's outputs, as run_tile writes them: n_thc from the latched
// sums (the sea count as the plain version forms it), then the trigger
// tail.  B1 writes only the cells of its ever-coastal tiles.
template <int MODE>
__global__ void __launch_bounds__(SWEEP_NT)
sweep_final(const Fields f, const Scalars s, const SweepArgs a) {
  const long long c = (long long)blockIdx.x * SWEEP_NT + threadIdx.x;
  if (c >= (long long)s.h * s.w) return;
  const int y = (int)(c / s.w), x = (int)(c % s.w);
  if (MODE == STACKED && !f.ever[(y / TH) * ((s.w + TW - 1) / TW) + x / TW])
    return;
  const float cdc = f.cd[c];
  const bool coastal = fabsf(cdc) <= s.maxdist;
  float n_thc = 0.0f;
  if (coastal) {
    const int rc = a.rc[c];
    const float nl = a.nl[c];
    const float2 W = a.W[c];
    const float ns = __fsub_rn((float)((2 * rc + 1) * (2 * rc + 1)), nl);
    const float mul = cdc >= 0.0f ? 1.0f : -1.0f;
    n_thc = mul * (W.x / fmaxf(nl, 1.0f) - W.y / fmaxf(ns, 1.0f));
  }
  if (MODE == THC) {
    f.sb_out[c] = n_thc;
    return;
  }
  const bool row_ok = s.row_offset + y < s.row_limit;
  const float wss = f.ws_state[c], wds = f.wd_state[c];
  float sb, ws_o, wd_o;
  trigger_tail(n_thc, coastal, f.ws_new[c], f.wd_new[c], wss, wds, s, sb,
               ws_o, wd_o);
  f.sb_out[c] = row_ok ? sb : 0.0f;
  if (MODE == PADDED) {
    f.ws_out[c] = row_ok ? ws_o : wss;
    f.wd_out[c] = row_ok ? wd_o : wds;
  } else {
    f.ws_out[c] = row_ok ? ws_o : 0.0f;
    f.wd_out[c] = row_ok ? wd_o : 0.0f;
    if (row_ok) {
      f.ws_state[c] = ws_o;
      f.wd_state[c] = wd_o;
    }
  }
}

// The sweep's launches after the integral image: the counters zeroed, the
// latch radii, the catch-up, one launch per band and one more for the last
// band's windows (a band past the widest latch radius returns at once),
// the outputs.
template <int MODE>
int launch_sweep(const Fields& f, const Scalars& s, cudaStream_t st) {
  const SweepLayout L = sweep_layout(s.h, s.w, s.nn);
  int* base = f.land_ii;
  const SweepArgs a{base + L.hdr,
                    base + L.hdr + s.w,
                    base + L.hdr + s.w + s.h,
                    base + L.rc,
                    reinterpret_cast<float*>(base + L.nl),
                    reinterpret_cast<float2*>(base + L.W),
                    reinterpret_cast<float2*>(base + L.hps),
                    reinterpret_cast<float2*>(base + L.vcs),
                    reinterpret_cast<float2*>(base + L.buf),
                    L.band,
                    L.wb};
  const cudaError_t err =
      cudaMemsetAsync(a.Rcol, 0, sizeof(int) * (s.w + s.h + 1), st);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)s.h * s.w;
  const int cblocks = (int)((cells + SWEEP_NT - 1) / SWEEP_NT);
  sweep_latch<MODE><<<cblocks, SWEEP_NT, 0, st>>>(f, s, a);
  const Warps all = sweep_warps(s.h, s.w, s.nn, 0, 0, true);
  const long long nw = (long long)all.n_hp + all.n_vc;
  sweep_catchup<<<(int)((nw + SWEEP_WARPS - 1) / SWEEP_WARPS), SWEEP_NT, 0,
                  st>>>(f, s, a, all);
  for (int b = 0; b <= L.nb; ++b) {
    const int n0 = 1 + b * L.band;
    Warps k{0, -1, 0, 0, -1, 0, 0, 0};
    if (b < L.nb)
      k = sweep_warps(s.h, s.w, s.nn, n0, min(n0 + L.band - 1, s.nn), false);
    const int wblocks = (k.n_hp + k.n_vc + SWEEP_WARPS - 1) / SWEEP_WARPS;
    sweep_band<<<wblocks + (b > 0 ? cblocks : 0), SWEEP_NT, 0, st>>>(
        f, s, a, k, b, wblocks);
  }
  sweep_final<MODE><<<cblocks, SWEEP_NT, 0, st>>>(f, s, a);
  return (int)cudaGetLastError();
}

// The integral image of land of the padded (ph, pw) field into ii, the
// first two kernels of every launch from LARGE_FROM on.
int land_image(const float* cd_pad, int* ii, int ph, int pw,
               cudaStream_t st) {
  land_rows<<<(ph + 7) / 8, 256, 0, st>>>(cd_pad, ii, ph, pw);
  land_cols<<<(pw + 31) / 32, 512, 0, st>>>(ii, ph, pw);
  return (int)cudaGetLastError();
}

// The elements of hp ((TH+2NN) x TW) and vc (TH x (TW+2NN)) per thread
// decide the build below LARGE_FROM: NN <= 24 owns at most 4 and 3, NN <=
// 64 9 and 5 (whose strip fits an H100's 227 KB a block up to NN = 57).
// From LARGE_FROM the large build, from SWEEP_FROM (past EXACT_NN) to
// MAX_NN the sweep, where the padded field's cells fit the int32 integral
// image; beyond, a refusal.
template <int MODE>
int launch(const Fields& f, const Scalars& s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.nn > MAX_NN) return (int)cudaErrorInvalidValue;
  if (s.nn >= LARGE_FROM) {  // the integral image of land, then the tiles
    if (f.land_ii == nullptr) return (int)cudaErrorInvalidValue;
    if ((long long)(s.h + 2 * s.nn) * (s.w + 2 * s.nn) > MAX_IMAGE_CELLS)
      return (int)cudaErrorInvalidValue;
    const int err = land_image(f.cd_pad, f.land_ii, s.h + 2 * s.nn,
                               s.w + 2 * s.nn, st);
    if (err != cudaSuccess) return err;
    if (takes_sweep(s.nn)) return launch_sweep<MODE>(f, s, st);
    return launch_build<MODE, 0, 0>(f, s, st);
  }
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
    float thresh_thc, int* scratch, void* stream) {
  const size_t slot = (size_t)step * h * w;
  const Fields f{t0_pad, cd_pad, cd, ws_new, wd_new, ws_state, wd_state,
                 ever, sb_buf + slot, ws_buf + slot, wd_buf + slot, scratch};
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
    int* scratch, void* stream) {
  // B4 never writes the state it reads
  const Fields f{t0_pad, cd_pad, cd, ws_new, wd_new,
                 const_cast<float*>(ws_state), const_cast<float*>(wd_state),
                 nullptr, sb_out, ws_out, wd_out, scratch};
  return launch<PADDED>(
      f, make_scalars(h, w, nn, is_first, upd, row_offset, nlat_total,
                      skip_last_row, maxdist, thresh_wind, thresh_winddir,
                      thresh_windch, thresh_thc),
      stream);
}

extern "C" int sbz_ring_thc_padded(const float* t0_pad, const float* cd_pad,
                                   const float* cd, float* n_thc, int h,
                                   int w, int nn, float maxdist, int* scratch,
                                   void* stream) {
  const Fields f{t0_pad, cd_pad, cd, nullptr, nullptr, nullptr, nullptr,
                 nullptr, n_thc, nullptr, nullptr, scratch};
  return launch<THC>(
      f, make_scalars(h, w, nn, 0, 0, 0, h, 0, maxdist, 0.0f, 0.0f, 0.0f,
                      0.0f),
      stream);
}

// The scratch each launcher needs at radius nn over an (h, w) field, in
// ints of device memory: from LARGE_FROM on, the integral image of land,
// (h + 2 nn + 1) x (w + 2 nn + 1), and from SWEEP_FROM on after it the
// sweep's (SweepLayout); below LARGE_FROM none (scratch may be null).
// Returns 0.
extern "C" int sbz_ring_scratch(int h, int w, int nn, long long* ints) {
  *ints = takes_sweep(nn)      ? sweep_layout(h, w, nn).total
          : nn >= LARGE_FROM ? (long long)(h + 2 * nn + 1) * (w + 2 * nn + 1)
                             : 0;
  return 0;
}

// The integral image of land alone, (ph + 1) x (pw + 1) ints of the padded
// (ph, pw) field into ii, as the launchers build it from LARGE_FROM on: so
// that its two kernels can be timed apart.  Returns cudaGetLastError().
extern "C" int sbz_ring_land_image(const float* cd_pad, int* ii, int ph,
                                   int pw, void* stream) {
  return land_image(cd_pad, ii, ph, pw, (cudaStream_t)stream);
}

// The ring radii the launchers take: the large build from *large_from,
// every build up to *max_nn, where the padded field has at most
// *max_cells cells (the int32 integral image's limit).  Returns 0.
extern "C" int sbz_ring_limits(int* large_from, int* max_nn,
                               long long* max_cells) {
  *large_from = LARGE_FROM;
  *max_nn = MAX_NN;
  *max_cells = MAX_IMAGE_CELLS;
  return 0;
}
