// Kernel B3 as it was before the wide-radius redesign (csrc/
// min_haversine.cu then), kept to be timed beside the port's
// (tools/compare_designs.py --only B3: `ring`).  Its large build (k >
// MAX_K) sweeps each chunk of rows with the ring of pass-1 rows and the
// coast bits in device scratch, every pass-2 tap of every cell; the
// port's now runs pass 1 once per padded row and pass 2 centre-out with
// an early exit (PERF.md §6).

// Kernel B3: both passes of the separable coast-distance minimum, fused,
// for Hopper.
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
// What bounds it on an H100.  The least time is set by device memory (the
// padded coast field in, amin out); what it takes is pass 2's taps, 2k+1
// per output cell whose window holds coast (311 at the 1 km world's
// k = 155), each a ring load, a table load and three float operations,
// and the latency of each row's loads.  The first design (one block per
// 16 x 32 tile staging its (16+2k) x (32+2k) coast strip, tools/designs/
// min_haversine_variants.cu) read the strip (16+2k)(32+2k)/512 times per
// output cell (86 at k = 93), ran pass 1 on each tile's 2k halo rows again
// and needed shared memory growing as k squared, which a block could not
// hold from k = 89 on.
//
// Design: a block of 8 warps owns a band of output columns and a chunk of
// output rows, and sweeps down the chunk's padded rows once, eight at a
// time (one per warp).  A lane owns two columns of a band of 64 where
// k <= 64 (the per-row work of a warp then serves twice the outputs), one
// of a band of 32 above (half the ring, so k reaches 354).
// * Each warp copies its row's coast window (band + 2k cells) with
//   cp.async, in 16-byte pieces from the 16-byte boundary at or before the
//   window (any row pitch), and the sdphi2 and po rows of the output row it
//   will finish at that stage, interleaved, 4 bytes a copy.  Rows are
//   copied three stages ahead where k <= 32, one stage ahead above (shared
//   memory, occupancy).  The window becomes coast bits, one ballot per 32
//   cells.
// * Pass 1 by bits.  Where the column's sdlam2 row does not increase from
//   either end of the window to its centre tap and does not decrease from
//   the centre to the other end (checked on the host per column,
//   ops.distance.window_monotone: a global uniform grid's every column, a
//   regional grid's columns but those within k of its seam), the masked
//   minimum is the smaller of the table values at the nearest coast cell
//   at or left of the centre and the nearest at or right of it: a word
//   scan each way, two table loads.  Elsewhere the minimum runs over the
//   set bits only.  Either way it is a minimum of the table's own values,
//   so bit-equal.  Each pass-1 row goes into a ring of the last 2k+16 rows:
//   pass 1 runs once per padded row of the chunk.  A window without coast
//   stores +inf instead of BIG: a pass-2 candidate from it is then +inf or
//   NaN (po = 0), which fminf passes over, as the plain version's BIG
//   candidate leaves its minimum (which starts at BIG) unchanged, so no
//   select is needed per tap.
// * Pass 2 per output row, one warp each, from the ring, the tables from
//   shared memory: a row whose 2k+1 pass-1 rows held no coast (the block
//   tracks the last padded row that did) is BIG without taps.  The multiply
//   and the add are rounded separately (__fmul_rn, __fadd_rn): nvcc would
//   otherwise contract them into an FMA, and the result is then bit-equal
//   to the plain version, which runs them as two torch ops (as kernel B2
//   does).
// * The chunk height is chosen at launch so that the blocks fill the
//   card's resident block slots once (the occupancy calculator): a chunk
//   also sweeps 2k halo rows, pass 1 only, so shorter chunks cost more.
// * Shared memory grows linearly in k: the ring and each warp's row and
//   table buffers.  MAX_K is the widest k a block holds; the library
//   exports it (sbz_min_haversine_limits).
// The large build, for k > MAX_K (0.4 km grids, k = 387, and wider), keeps
// the same sweep with nothing in shared memory that grows with k: the ring
// of 2k+16 pass-1 rows and each warp's coast bit words live in a scratch
// buffer in device memory that the caller allocates
// (sbz_min_haversine_scratch), small enough with at most two blocks per SM
// to stay in L2 (100 KB a block at k = 387); the coast bits are balloted
// from the padded field as read, and pass 2 reads each output row's
// (sdphi2, po) taps through L1 (__ldg, one address a warp) instead of
// staging them.  One column a lane, no rows copied ahead.
// Every design built on the way, and the thresholds above, were timed
// against each other (tools/compare_designs.py --only B3, PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1.0e30f;
constexpr int S = 8;                // warps per block = padded rows a stage
constexpr int NT = 32 * S;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold
// Up to these k: two columns a lane (bands of 64), and rows copied three
// stages ahead.  Above: one column a lane (bands of 32, half the ring),
// and one stage ahead.
constexpr int CPL2_UP_TO = 64;
constexpr int DEEP_UP_TO = 32;

// floats of one coast row buffer: the window and up to 3 cells before it
__host__ __device__ constexpr int row_floats(int k, int tb) {
  return (tb + 2 * k + 3 + 3) & ~3;
}
__host__ __device__ constexpr int row_words(int k, int tb) {
  return (tb + 2 * k + 31) >> 5;
}
__host__ __device__ constexpr int ring_rows(int k) { return 2 * k + 2 * S; }

// the ring, then per warp nbuf coast rows, nbuf (sdphi2, po) rows and the
// bit words, and the last coast row; tb: the band's columns
constexpr size_t smem_bytes(int k, int nbuf, int tb) {
  return sizeof(float) *
         ((size_t)ring_rows(k) * tb +
          (size_t)S * nbuf * (row_floats(k, tb) + 2 * (2 * k + 1)) +
          (size_t)S * row_words(k, tb) + 4);
}

constexpr int max_k() {
  int k = 0;
  while (smem_bytes(k + 1, 2, 32) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_K = max_k();
static_assert(smem_bytes(CPL2_UP_TO, 2, 64) <= SMEM_OPTIN &&
                  smem_bytes(DEEP_UP_TO, 4, 64) <= SMEM_OPTIN,
              "the small builds' shared memory");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float tap(float2 t, float lo) {
  return __fadd_rn(t.x, __fmul_rn(t.y, lo));
}

// NBUF: buffers per warp (rows in flight: NBUF - 1 stages ahead); CPL:
// columns per lane (lane l owns band columns l, l + 32, ...)
template <int NBUF, int CPL>
__global__ void __launch_bounds__(NT)
min_haversine_kernel(const float* __restrict__ cpad,
                     const float* __restrict__ sdphi2,
                     const float* __restrict__ po,
                     const float* __restrict__ sdlam2,
                     const unsigned char* __restrict__ col_mono,
                     float* __restrict__ out, int h, int w, int k, int ch) {
  constexpr int TB = 32 * CPL;           // band columns
  constexpr int U = 4 / CPL;             // pass-2 taps a step
  const int nwin = 2 * k + 1, pw = w + 2 * k, win = TB + 2 * k;
  const int nring = ring_rows(k), rowf = row_floats(k, TB);
  const int nw = row_words(k, TB);
  const long long total = (long long)(h + 2 * k) * pw;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TB, r0 = blockIdx.y * ch;
  const int r1 = min(r0 + ch, h);
  const int nrows = r1 - r0 + 2 * k;     // padded rows this block sweeps
  const int nst = (nrows + S - 1) / S;
  const int valid = min(win, pw - c0);   // window columns inside the field

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);          // nring x TB
  float* rows = ring + nring * TB;                        // S x NBUF x rowf
  float2* tabs0 = reinterpret_cast<float2*>(rows + S * NBUF * rowf);
  unsigned* words0 = reinterpret_cast<unsigned*>(tabs0 + S * NBUF * nwin);
  int* last_coast = reinterpret_cast<int*>(words0 + S * nw);
  float* rowb = rows + wid * NBUF * rowf;
  float2* tabb = tabs0 + wid * NBUF * nwin;
  unsigned* words = words0 + wid * nw;

  // Stage t of this warp: padded row r0 + t*S + wid (pass 1) and output
  // row r0 + (t-1)*S + wid - 2k (pass 2), into buffer t % NBUF.  The coast
  // window in 16-byte pieces from the 16-byte boundary at or before it (a
  // piece that leaves the array is read cell by cell), the tables 4 bytes
  // a copy.
  auto issue = [&](int t) {
    const int rr = t * S + wid;
    if (t < nst && rr < nrows) {
      float* buf = rowb + (t % NBUF) * rowf;
      const long long g0 = (long long)(r0 + rr) * pw + c0;
      const int o = (int)((reinterpret_cast<uintptr_t>(cpad + g0) >> 2) & 3);
      const int npiece = (o + win + 3) >> 2;
      for (int i = lane; i < npiece; i += 32) {
        const long long g = g0 - o + 4 * i;
        if (g >= 0 && g + 4 <= total) {
          cp_async16(buf + 4 * i, cpad + g);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            buf[4 * i + u] = g + u >= 0 && g + u < total ? cpad[g + u] : 0.0f;
        }
      }
    }
    const int y = r0 + (t - 1) * S + wid - 2 * k;
    if (t >= 1 && y >= r0 && y < r1) {
      float* tb = reinterpret_cast<float*>(tabb + (t % NBUF) * nwin);
      const size_t g = (size_t)y * nwin;
      for (int i = lane; i < nwin; i += 32) {
        cp_async4(tb + 2 * i, sdphi2 + g + i);
        cp_async4(tb + 2 * i + 1, po + g + i);
      }
    }
  };

  if (threadIdx.x == 0) *last_coast = r0 - 1;
  bool xin[CPL], cmono[CPL];
  const float* lam[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int x = c0 + lane + 32 * c;
    xin[c] = x < w;
    cmono[c] = col_mono != nullptr && xin[c] && col_mono[x] != 0;
    lam[c] = sdlam2 + (size_t)x * nwin;
  }
#pragma unroll
  for (int t = 0; t < NBUF - 1; ++t) {
    issue(t);
    cp_async_commit();
  }
  __syncthreads();

  int slot = wid;                        // ring slot of this warp's row
  for (int s = 0; s <= nst; ++s) {
    issue(s + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();
    __syncwarp();

    // ---- pass 1 on padded row r0 + s*S + wid
    const int rr = s * S + wid;
    if (s < nst && rr < nrows) {
      const int pr = r0 + rr;
      const float* buf = rowb + (s % NBUF) * rowf;
      const int o = (int)((reinterpret_cast<uintptr_t>(
                               cpad + (long long)pr * pw + c0) >> 2) & 3);
      unsigned any = 0;
      for (int j = 0; j < nw; ++j) {
        const int c = 32 * j + lane;
        const unsigned b = __ballot_sync(~0u, c < valid && buf[o + c] > 0.0f);
        if (lane == 0) words[j] = b;
        any |= b;
      }
      __syncwarp();
      bool found = false;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int lo = lane + 32 * cc;   // window start of this column
        float m = INFINITY;
        if (any && xin[cc]) {
          const int p = lo + k, hi = lo + 2 * k;  // centre, window end
          if (cmono[cc]) {
            // the nearest coast at or left of the centre, then at or right
            int wi = p >> 5;
            unsigned b = words[wi] & (0xFFFFFFFFu >> (31 - (p & 31)));
            while (!b && wi > (lo >> 5)) b = words[--wi];
            if (b) {
              const int c = (wi << 5) + 31 - __clz(b);
              if (c >= lo) m = __ldg(lam[cc] + c - lo);
            }
            wi = p >> 5;
            b = words[wi] & (0xFFFFFFFFu << (p & 31));
            while (!b && wi < (hi >> 5)) b = words[++wi];
            if (b) {
              const int c = (wi << 5) + __ffs(b) - 1;
              if (c <= hi) m = fminf(m, __ldg(lam[cc] + c - lo));
            }
          } else {
            for (int wi = lo >> 5; wi <= (hi >> 5); ++wi) {
              unsigned b = words[wi];
              if (wi == (lo >> 5)) b &= 0xFFFFFFFFu << (lo & 31);
              if (wi == (hi >> 5)) b &= 0xFFFFFFFFu >> (31 - (hi & 31));
              while (b) {
                const int c = (wi << 5) + __ffs(b) - 1;
                b &= b - 1;
                m = fminf(m, __ldg(lam[cc] + c - lo));
              }
            }
          }
        }
        ring[slot * TB + lo] = m;
        found |= m < 0.5f * BIG;
      }
      if (__any_sync(~0u, found) && lane == 0) atomicMax(last_coast, pr);
    }
    slot += S;
    if (slot >= nring) slot -= nring;

    // ---- pass 2 on output row y, whose last window row was in stage s-1
    // (last_coast may already count this stage's rows: a later row only
    // keeps a row from being skipped)
    const int y = r0 + (s - 1) * S + wid - 2 * k;
    if (s >= 1 && y >= r0 && y < r1) {
      float acc[CPL][U];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int u = 0; u < U; ++u) acc[c][u] = BIG;
      if (*reinterpret_cast<volatile int*>(last_coast) >= y) {
        const float2* tb = tabb + (s % NBUF) * nwin;
        const int base = (y - r0) % nring;     // ring slot of padded row y
        const int first = min(nwin, nring - base);
        const float* rg = ring + base * TB + lane;
        int di = 0;
        // taps di in [0, first) from slots base + di, then the rest from
        // slots di - first, past the ring's end
        for (int end = first; ; end = nwin) {
          for (; di + U <= end; di += U) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const float2 t = tb[di + u];
#pragma unroll
              for (int c = 0; c < CPL; ++c)
                acc[c][u] = fminf(acc[c][u],
                                  tap(t, rg[(di + u) * TB + 32 * c]));
            }
          }
          for (; di < end; ++di) {
            const float2 t = tb[di];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[c][0] = fminf(acc[c][0], tap(t, rg[di * TB + 32 * c]));
          }
          if (end == nwin) break;
          rg = ring + lane - first * TB;
        }
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float amin = acc[c][0];
#pragma unroll
        for (int u = 1; u < U; ++u) amin = fminf(amin, acc[c][u]);
        if (xin[c]) out[(size_t)y * w + c0 + lane + 32 * c] = amin;
      }
    }
    __syncthreads();
  }
}

template <int NBUF, int CPL>
int launch(const float* cpad, const float* sdphi2, const float* po,
           const float* sdlam2, const unsigned char* col_mono, float* out,
           int h, int w, int k, cudaStream_t stream) {
  auto kernel = min_haversine_kernel<NBUF, CPL>;
  const size_t smem = smem_bytes(k, NBUF, 32 * CPL);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 1, per_sm = 1;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  // the chunk height: the bands times the chunks fill the resident block
  // slots once over
  const int bands = (w + 32 * CPL - 1) / (32 * CPL);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  int ch = (int)(((long long)h * bands + slots - 1) / slots);
  ch = ch < S ? S : ch;
  ch = ch > h ? h : ch;
  const dim3 grid(bands, (h + ch - 1) / ch);
  kernel<<<grid, NT, smem, stream>>>(cpad, sdphi2, po, sdlam2, col_mono, out,
                                     h, w, k, ch);
  return (int)cudaGetLastError();
}

// ---- the large build (k > MAX_K)

// At most this many blocks per SM, so that their rings stay in L2.
constexpr int LARGE_PER_SM = 2;

// floats of one block's scratch: its ring (one column a lane) and each
// warp's coast bit words, rounded to 16 bytes
__host__ __device__ inline long long large_block_floats(int k) {
  return ((long long)ring_rows(k) * 32 + (long long)S * row_words(k, 32) +
          3) & ~3LL;
}

__global__ void __launch_bounds__(NT)
min_haversine_large_kernel(const float* __restrict__ cpad,
                           const float* __restrict__ sdphi2,
                           const float* __restrict__ po,
                           const float* __restrict__ sdlam2,
                           const unsigned char* __restrict__ col_mono,
                           float* __restrict__ out, float* scratch, int h,
                           int w, int k, int ch) {
  const int nwin = 2 * k + 1, pw = w + 2 * k, win = 32 + 2 * k;
  const int nring = ring_rows(k), nw = row_words(k, 32);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * ch;
  const int r1 = min(r0 + ch, h);
  const int nrows = r1 - r0 + 2 * k;     // padded rows this block sweeps
  const int nst = (nrows + S - 1) / S;
  const int valid = min(win, pw - c0);   // window columns inside the field
  // not restrict: written and read back by the block's own threads
  float* ring = scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                              large_block_floats(k);
  unsigned* words =
      reinterpret_cast<unsigned*>(ring + (size_t)nring * 32) + wid * nw;
  __shared__ int last_coast;
  if (threadIdx.x == 0) last_coast = r0 - 1;
  const int x = c0 + lane;
  const bool xin = x < w;
  const bool cmono = col_mono != nullptr && xin && col_mono[x] != 0;
  const float* lam = sdlam2 + (size_t)(xin ? x : 0) * nwin;
  __syncthreads();

  int slot = wid;                        // ring slot of this warp's row
  for (int s = 0; s <= nst; ++s) {
    // ---- pass 1 on padded row r0 + s*S + wid
    const int rr = s * S + wid;
    if (s < nst && rr < nrows) {
      const int pr = r0 + rr;
      const float* row = cpad + (size_t)pr * pw + c0;
      unsigned any = 0;
#pragma unroll 4
      for (int j = 0; j < nw; ++j) {
        const int c = 32 * j + lane;
        const unsigned b =
            __ballot_sync(~0u, c < valid && __ldg(row + c) > 0.0f);
        if (lane == 0) words[j] = b;
        any |= b;
      }
      __syncwarp();
      float m = INFINITY;
      if (any && xin) {
        const int lo = lane, p = lo + k, hi = lo + 2 * k;
        if (cmono) {
          // the nearest coast at or left of the centre, then at or right
          int wi = p >> 5;
          unsigned b = words[wi] & (0xFFFFFFFFu >> (31 - (p & 31)));
          while (!b && wi > (lo >> 5)) b = words[--wi];
          if (b) {
            const int c = (wi << 5) + 31 - __clz(b);
            if (c >= lo) m = __ldg(lam + c - lo);
          }
          wi = p >> 5;
          b = words[wi] & (0xFFFFFFFFu << (p & 31));
          while (!b && wi < (hi >> 5)) b = words[++wi];
          if (b) {
            const int c = (wi << 5) + __ffs(b) - 1;
            if (c <= hi) m = fminf(m, __ldg(lam + c - lo));
          }
        } else {
          for (int wi = lo >> 5; wi <= (hi >> 5); ++wi) {
            unsigned b = words[wi];
            if (wi == (lo >> 5)) b &= 0xFFFFFFFFu << (lo & 31);
            if (wi == (hi >> 5)) b &= 0xFFFFFFFFu >> (31 - (hi & 31));
            while (b) {
              const int c = (wi << 5) + __ffs(b) - 1;
              b &= b - 1;
              m = fminf(m, __ldg(lam + c - lo));
            }
          }
        }
      }
      ring[(size_t)slot * 32 + lane] = m;
      if (__any_sync(~0u, m < 0.5f * BIG) && lane == 0)
        atomicMax(&last_coast, pr);
    }
    slot += S;
    if (slot >= nring) slot -= nring;

    // ---- pass 2 on output row y, whose last window row was in stage s-1
    const int y = r0 + (s - 1) * S + wid - 2 * k;
    if (s >= 1 && y >= r0 && y < r1) {
      float acc[4] = {BIG, BIG, BIG, BIG};
      if (*reinterpret_cast<volatile int*>(&last_coast) >= y) {
        const float* tp = sdphi2 + (size_t)y * nwin;
        const float* tq = po + (size_t)y * nwin;
        const int base = (y - r0) % nring;     // ring slot of padded row y
        const int first = min(nwin, nring - base);
        // taps di in [0, first) from slots base + di, then the rest from
        // slots di - first, past the ring's end
        long long off = (long long)base * 32 + lane;
        int di = 0;
        for (int end = first; ; end = nwin) {
          for (; di + 4 <= end; di += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[u] = fminf(acc[u],
                             tap(make_float2(__ldg(tp + di + u),
                                             __ldg(tq + di + u)),
                                 ring[off + (long long)(di + u) * 32]));
          }
          for (; di < end; ++di)
            acc[0] = fminf(acc[0], tap(make_float2(__ldg(tp + di),
                                                   __ldg(tq + di)),
                                       ring[off + (long long)di * 32]));
          if (end == nwin) break;
          off = lane - (long long)first * 32;
        }
      }
      if (xin)
        out[(size_t)y * w + x] =
            fminf(fminf(acc[0], acc[1]), fminf(acc[2], acc[3]));
    }
    __syncthreads();
  }
}

// The large build's grid: bands of 32 columns times chunks of rows, the
// blocks filling at most LARGE_PER_SM block slots per SM once over.
int large_grid(int h, int w, int k, dim3* grid, int* ch) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, min_haversine_large_kernel, NT, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  per_sm = per_sm < 1 ? 1 : (per_sm > LARGE_PER_SM ? LARGE_PER_SM : per_sm);
  const int bands = (w + 31) / 32;
  const long long slots = (long long)sms * per_sm;
  int c = (int)(((long long)h * bands + slots - 1) / slots);
  c = c < S ? S : c;
  c = c > h ? h : c;
  *grid = dim3(bands, (h + c - 1) / c);
  *ch = c;
  return 0;
}

}  // namespace

// The widest k of the builds that stage in shared memory; wider k takes the
// large build (sbz_min_haversine_large).
extern "C" int sbz_min_haversine_limits(int* max_k) {
  *max_k = MAX_K;
  return 0;
}

// Floats of device scratch the large build needs at (h, w, k) on the
// current device (0 for k <= MAX_K).
extern "C" int sbz_min_haversine_scratch(int h, int w, int k,
                                         long long* floats) {
  *floats = 0;
  if (k <= MAX_K || h <= 0 || w <= 0) return 0;
  dim3 grid;
  int ch = 0;
  const int err = large_grid(h, w, k, &grid, &ch);
  if (err) return err;
  *floats = (long long)grid.x * grid.y * large_block_floats(k);
  return 0;
}

// The large build, any k > MAX_K; scratch: sbz_min_haversine_scratch floats
// of device memory, 16-byte aligned.  Arguments otherwise as below.
extern "C" int sbz_min_haversine_large(const float* cpad, const float* sdphi2,
                                       const float* po, const float* sdlam2,
                                       const unsigned char* col_mono,
                                       float* out, int h, int w, int k,
                                       float* scratch, void* stream) {
  if (k <= MAX_K || h <= 0 || w <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  int ch = 0;
  const int err = large_grid(h, w, k, &grid, &ch);
  if (err) return err;
  min_haversine_large_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      cpad, sdphi2, po, sdlam2, col_mono, out, scratch, h, w, k, ch);
  return (int)cudaGetLastError();
}

// col_mono (w bytes): nonzero where the column's row of sdlam2 has the
// monotone property (header); null: no column is taken to have it.
extern "C" int sbz_min_haversine(const float* cpad, const float* sdphi2,
                                 const float* po, const float* sdlam2,
                                 const unsigned char* col_mono, float* out,
                                 int h, int w, int k, void* stream) {
  if (k < 0 || k > MAX_K || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= DEEP_UP_TO)
    return launch<4, 2>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, s);
  if (k <= CPL2_UP_TO)
    return launch<2, 2>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, s);
  return launch<2, 1>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, s);
}
