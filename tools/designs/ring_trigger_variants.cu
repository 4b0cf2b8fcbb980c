// Kernel B1 (STACKED form only), two design alternatives to
// seabreeze_param_tpu_torch/csrc/ring_trigger.cu with the same C interface
// (sbz_ring_trigger_stacked), kept so that tools/compare_designs.py can
// time them beside it.  Same function, bit for bit; the same ring routine
// (float2 (tl, ts) strip, land counts from an integral image sharing the
// running sums' space, sums in registers, one barrier per radius) and the
// same persistent grid that ranks the ever-coastal tiles.  Two options,
// set at compile time:
//
// * SBZ_RING_CPT (1 or 2): cells per thread.  2 makes the tile 32 x 32
//   (512 threads, rows ty and ty + 16): less halo per output cell
//   (4.8x the outputs at NN = 19 against 7.4x) at more registers.
// * SBZ_RING_PREFETCH (0 or 1): the next tile's raw (t0, cd) strip is
//   copied into a staging buffer with cp.async while this tile runs its
//   ring loop, so a block's second and later tiles find their strip in
//   shared memory.  8 bytes more shared memory per strip cell.
//
// sbz_ring_tile reports the tile, so the caller builds the ever-coastal
// mask at the tile of the build.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SBZ_RING_CPT
#define SBZ_RING_CPT 1
#endif
#ifndef SBZ_RING_PREFETCH
#define SBZ_RING_PREFETCH 0
#endif
constexpr int CPT = SBZ_RING_CPT;        // cells per thread (rows apart 16)
constexpr bool PREFETCH = SBZ_RING_PREFETCH;
constexpr int TY = 16;                   // thread rows
constexpr int TH = TY * CPT;             // tile rows
constexpr int TW = 32;                   // tile columns
constexpr int NT = TY * TW;
constexpr int NWARP = NT / 32;
constexpr int RUN = 64;
constexpr float MISSING = 2.0e20f;
constexpr float SENTINEL = 12000.0f;

// In float2 units: the strip, the running sums or the integral image
// (which share their space), and with PREFETCH the staging buffer.
size_t smem_bytes(int nn, int nbuf) {
  const size_t sh = TH + 2 * nn, sw = TW + 2 * nn;
  const size_t sums = nbuf * (sh * TW + TH * sw);
  const size_t image = ((sh + 1) * (sw + 1) + 1) / 2;
  const size_t stage = PREFETCH ? sh * sw : 0;
  return sizeof(float2) * (sh * sw + (sums > image ? sums : image) + stage);
}

__device__ __forceinline__ float floor_mod360(float x) {
  float r = fmodf(x, 360.0f);
  if (r != 0.0f && r < 0.0f) r += 360.0f;
  return r;
}

struct Scalars {
  int h, w, nn, is_first, upd, row_offset, row_limit, nbuf;
  float maxdist, thresh_wind, thresh_winddir, thresh_windch, thresh_thc;
};

struct Fields {
  const float* t0_pad;
  const float* cd_pad;
  const float* cd;
  const float* ws_new;
  const float* wd_new;
  float* ws_state;
  float* wd_state;
  const unsigned char* ever;
  float* sb_out;
  float* ws_out;
  float* wd_out;
};

__device__ __forceinline__ void add2(float2& v, const float2& a,
                                     const float2& b) {
  v.x = (v.x + a.x) + b.x;
  v.y = (v.y + a.y) + b.y;
}

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The raw (t0, cd) strip of the tile at (r0, c0) into the staging buffer,
// every copy in flight; the ragged edge stored directly.
__device__ void stage_strip(const Fields& f, const Scalars& s, int r0,
                            int c0, float2* st) {
  const int NN = s.nn, SH = TH + 2 * NN, SW = TW + 2 * NN;
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  for (int e = threadIdx.x; e < SH * SW; e += NT) {
    const int r = e / SW, cc = e - r * SW;
    const int gr = r0 + r, gc = c0 + cc;
    if (gr < ph && gc < pw) {
      cp_async4(&st[e].x, f.t0_pad + (size_t)gr * pw + gc);
      cp_async4(&st[e].y, f.cd_pad + (size_t)gr * pw + gc);
    } else {
      st[e] = make_float2(0.0f, SENTINEL);
    }
  }
}

// Ring search of the tile at (r0, c0) for the thread's CPT cells.  With
// PREFETCH, `staged` says the strip is in the staging buffer, and the
// strip of the tile at (nr0, nc0) (nr0 < 0: none) is staged once this
// one's is read.
template <int HS, int VS>
__device__ void ring_thc_tile(const Fields& f, const Scalars& s, int r0,
                              int c0, const bool* coastal, const float* cdc,
                              float* n_thc, bool staged, int nr0, int nc0) {
  __shared__ int s_rmax[NWARP];
  const int NN = s.nn;
  const int SH = TH + 2 * NN, SW = TW + 2 * NN;
  const int IW = SW + 1;
  const int ph = s.h + 2 * NN, pw = s.w + 2 * NN;
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int lane = tid % 32, warp = tid / 32;

  extern __shared__ float2 smem2[];
  float2* s_p = smem2;
  float2* s_h = s_p + SH * SW;
  float2* s_v = s_h + s.nbuf * SH * TW;
  int* s_i = reinterpret_cast<int*>(s_h);
  const size_t sums = (size_t)s.nbuf * (SH * TW + TH * SW);
  const size_t image = ((size_t)(SH + 1) * IW + 1) / 2;
  float2* s_st = s_h + (sums > image ? sums : image);  // staging

  const int n = SH * SW;
  if (PREFETCH && staged) {
    for (int e = tid; e < n; e += NT) {
      const float2 v = s_st[e];
      const int r = e / SW, cc = e - r * SW;
      const float land = v.y >= 0.0f ? 1.0f : 0.0f;
      const float tl = __fmul_rn(v.x, land);
      s_p[e] = make_float2(tl, __fsub_rn(v.x, tl));
      s_i[(r + 1) * IW + cc + 1] = v.y >= 0.0f;
    }
  } else {
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
  }
  for (int i = tid; i < IW + SH; i += NT)
    s_i[i < IW ? i : (i - IW + 1) * IW] = 0;
  __syncthreads();
  if (PREFETCH && nr0 >= 0) stage_strip(f, s, nr0, nc0, s_st);
  for (int r = 1 + warp; r <= SH; r += NWARP)
    warp_prefix(s_i + r * IW + 1, SW, 1, lane);
  __syncthreads();
  for (int c = 1 + warp; c <= SW; c += NWARP)
    warp_prefix(s_i + IW + c, SH, IW, lane);
  __syncthreads();

  int rc[CPT], n_land[CPT], rmax = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int y = ty + TY * j;
    rc[j] = 0;
    n_land[j] = 0;
    if (coastal[j]) {
      rc[j] = NN;
      for (int nn = 1; nn <= NN; ++nn) {
        const int a = (y + NN - nn) * IW, b = (y + NN + nn + 1) * IW;
        const int l = tx + NN - nn, r = tx + NN + nn + 1;
        n_land[j] = s_i[b + r] - s_i[a + r] - s_i[b + l] + s_i[a + l];
        if (n_land[j] > 0 && n_land[j] < (2 * nn + 1) * (2 * nn + 1)) {
          rc[j] = nn;
          break;
        }
      }
    }
    rmax = max(rmax, rc[j]);
  }
  const int wmax = __reduce_max_sync(0xffffffffu, rmax);
  if (lane == 0) s_rmax[warp] = wmax;
  __syncthreads();

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
    if (vb[k] >= 0) s_v[(s.nbuf - 1) * TH * SW + e] = vc[k];
  }
  float2 W[CPT];
  float lat_tl[CPT], lat_ts[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    W[j] = s_p[(ty + TY * j + NN) * SW + tx + NN];
    lat_tl[j] = lat_ts[j] = 0.0f;
  }
  __syncthreads();
  int R = 0;
  for (int k = 0; k < NWARP; ++k) R = max(R, s_rmax[k]);

  for (int nn = 1; nn <= R; ++nn) {
    const int buf = s.nbuf == 2 ? (nn & 1) : 0;
    float2* hbuf = s_h + buf * SH * TW;
    float2* vbuf = s_v + buf * TH * SW;
    if (s.nbuf == 1 && nn > 1) __syncthreads();
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
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (nn > rc[j]) continue;
      const int y = ty + TY * j;
      const float2 top = hbuf[(y + NN - nn) * TW + tx];
      const float2 bot = hbuf[(y + NN + nn) * TW + tx];
      const float2 lft = vbuf[y * SW + tx + NN - nn];
      const float2 rgt = vbuf[y * SW + tx + NN + nn];
      W[j].x = (((W[j].x + top.x) + bot.x) + lft.x) + rgt.x;
      W[j].y = (((W[j].y + top.y) + bot.y) + lft.y) + rgt.y;
      if (nn == rc[j]) {
        lat_tl[j] = W[j].x;
        lat_ts[j] = W[j].y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float lat_nl = fmaxf((float)n_land[j], 1.0f);
    const float lat_ns = fmaxf(
        (float)((2 * rc[j] + 1) * (2 * rc[j] + 1)) - (float)n_land[j], 1.0f);
    const float mul = cdc[j] >= 0.0f ? 1.0f : -1.0f;
    n_thc[j] = coastal[j]
                   ? mul * (lat_tl[j] / lat_nl - lat_ts[j] / lat_ns)
                   : 0.0f;
  }
}

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

// One tile; returns whether its strip was read (so a staged next strip is
// in flight).
template <int HS, int VS>
__device__ bool run_tile(const Fields& f, const Scalars& s, int r0, int c0,
                         bool staged, int nr0, int nc0) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  bool inside[CPT], coastal[CPT], row_ok[CPT], any = false;
  float cdc[CPT], wss[CPT], wds[CPT], n_thc[CPT];
  size_t c[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int x = c0 + tx, y = r0 + ty + TY * j;
    inside[j] = x < s.w && y < s.h;
    c[j] = (size_t)y * s.w + x;
    cdc[j] = inside[j] ? f.cd[c[j]] : SENTINEL;
    coastal[j] = inside[j] && fabsf(cdc[j]) <= s.maxdist;
    row_ok[j] = s.row_offset + y < s.row_limit;
    wss[j] = inside[j] ? f.ws_state[c[j]] : 0.0f;
    wds[j] = inside[j] ? f.wd_state[c[j]] : 0.0f;
    any |= coastal[j];
  }
  if (!__syncthreads_or(any)) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!inside[j]) continue;
      f.sb_out[c[j]] = row_ok[j] ? MISSING : 0.0f;
      f.ws_out[c[j]] = row_ok[j] ? wss[j] : 0.0f;
      f.wd_out[c[j]] = row_ok[j] ? wds[j] : 0.0f;
    }
    return false;
  }
  ring_thc_tile<HS, VS>(f, s, r0, c0, coastal, cdc, n_thc, staged, nr0,
                        nc0);
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if (!inside[j]) continue;
    float sb, ws_o, wd_o;
    trigger_tail(n_thc[j], coastal[j], f.ws_new[c[j]], f.wd_new[c[j]],
                 wss[j], wds[j], s, sb, ws_o, wd_o);
    f.sb_out[c[j]] = row_ok[j] ? sb : 0.0f;
    f.ws_out[c[j]] = row_ok[j] ? ws_o : 0.0f;
    f.wd_out[c[j]] = row_ok[j] ? wd_o : 0.0f;
    if (row_ok[j]) {
      f.ws_state[c[j]] = ws_o;
      f.wd_state[c[j]] = wd_o;
    }
  }
  return true;
}

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

template <int HS, int VS>
__global__ void __launch_bounds__(NT, (HS <= 4 && VS <= 3) ? 2 : 1)
ring_kernel(const Fields f, const Scalars s) {
  __shared__ int s_list[NT];
  __shared__ int s_warp[NWARP];
  const int nj = (s.w + TW - 1) / TW;
  const int ntiles = nj * ((s.h + TH - 1) / TH);
  const int G = gridDim.x, b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  int base = 0;
  for (int c0 = 0; c0 < ntiles; c0 += NT * RUN) {
    const int n = min(ntiles - c0, NT * RUN);
    const int per = ((n + NT - 1) / NT + 15) / 16 * 16;
    const int first = c0 + threadIdx.x * per;
    const unsigned long long bits =
        first < ntiles ? ever_bits(f.ever, first, per, ntiles) : 0ull;
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
    const int o0 = (max(base - b, 0) + G - 1) / G;
    const int o1 = (max(base + count - b, 0) + G - 1) / G;
    int rank = base + off;
    for (unsigned long long m = bits; m; m &= m - 1, ++rank)
      if (rank % G == b)
        s_list[(rank - b) / G - o0] = first + __ffsll((long long)m) - 1;
    __syncthreads();
    bool staged = false;
    for (int k = 0; k < o1 - o0; ++k) {
      const int tile = s_list[k];
      const int next = k + 1 < o1 - o0 ? s_list[k + 1] : -1;
      if (PREFETCH) {
        cp_async_wait_all();
        __syncthreads();
      }
      staged = run_tile<HS, VS>(f, s, (tile / nj) * TH, (tile % nj) * TW,
                                staged,
                                next < 0 ? -1 : (next / nj) * TH,
                                next < 0 ? 0 : (next % nj) * TW) &&
               next >= 0;
    }
    if (PREFETCH) cp_async_wait_all();
    base += count;
    __syncthreads();
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int HS, int VS>
int launch_build(const Fields& f, Scalars s, cudaStream_t st) {
  auto kernel = ring_kernel<HS, VS>;
  cudaError_t err = cudaSuccess;
  int per_sm = 0;
  size_t smem = 0;
  for (s.nbuf = 2; s.nbuf >= 1; --s.nbuf) {
    smem = smem_bytes(s.nn, s.nbuf);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NT, smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) break;
    cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const int ntiles = ((s.w + TW - 1) / TW) * ((s.h + TH - 1) / TH);
  const int grid = per_sm * num_sms() < ntiles ? per_sm * num_sms() : ntiles;
  if (grid < ntiles && grid < RUN) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, NT, smem, st>>>(f, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" void sbz_ring_tile(int* th, int* tw) {
  *th = TH;
  *tw = TW;
}

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
  const Scalars s{h, w, nn, is_first, upd, row_offset,
                  skip_last_row ? nlat_total - 1 : nlat_total, 2,
                  maxdist, thresh_wind, thresh_winddir, thresh_windch,
                  thresh_thc};
  const cudaStream_t st = (cudaStream_t)stream;
  // hp ((TH+2NN) x TW) and vc (TH x (TW+2NN)) elements per thread
  if (CPT == 1 && nn <= 24) return launch_build<4, 3>(f, s, st);
  if (CPT == 2 && nn <= 24) return launch_build<5, 5>(f, s, st);
  return (int)cudaErrorInvalidValue;
}
