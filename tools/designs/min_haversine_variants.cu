// Kernel B3's designs, built and dropped or kept, for
// tools/compare_designs.py --only B3.  The same C interface as
// seabreeze_param_tpu_torch/csrc/min_haversine.cu; plain version
// seabreeze_param_tpu_torch/ops/distance.py::min_haversine_param_from_padded.
//
// SBZ_MH_DESIGN selects the design:
//
// 0  The port's first design (PR 2): one block of 16 x 32 threads per
//    16 x 32 output tile, its whole (16+2k) x (32+2k) coast strip staged
//    in shared memory by a strided loop, pass 1 on every strip row by the
//    tap loop, pass 2 from the strip's pass-1 minima.  Shared memory grows
//    as k squared: it refuses k >= 89.  Built with the sweep's interface
//    (the monotone flags are ignored) so the harness calls both alike.
// 1  The first sweep (built and timed in PR 8's first chip call): the
//    band's sdlam2 columns staged in shared memory, pass-2 tables read
//    through L1 per tap, a per-tap select on BIG, per-row sdphi2 monotone
//    flags beside the per-column sdlam2 ones (sbz_min_haversine_row_flags
//    marks the interface with both), with these options:
//    SBZ_MH_BITS   1: pass 1 from the coast bits (the nearest coast tap on
//                  each side where the column's table is monotone, else
//                  the set bits);  0: the tap loop over all 2k+1 taps.
//    SBZ_MH_EARLY  1: pass 2 from the centre row outward, stopping once no
//                  later tap can win, where the row's table is monotone;
//                  0: every tap in order.
//    SBZ_MH_WAVES  blocks per resident block slot the chunk height aims
//                  at (more: shorter chunks, more halo rows recomputed).
//    SBZ_MH_NBUF   padded rows in flight per warp, at most (2 or 4).
// 2  The second sweep (PR 8's second and third chip calls): design 3 with
//    one column a lane at every k, with these options:
//    SBZ_MH2_SELECT      1: BIG in the ring for a window without coast and
//                        a select per pass-2 tap; 0: +inf and no select.
//    SBZ_MH2_WAVES       blocks per resident block slot (as SBZ_MH_WAVES).
//    SBZ_MH2_DEEP_UP_TO  the k up to which rows are copied three stages
//                        ahead (above: one).
//    SBZ_MH2_CLOCKS      1: count each warp's cycles by part of a stage
//                        (sbz_min_haversine_clocks reads the counts).
// 3  The sweep of csrc/min_haversine.cu (whose header describes it), with
//    these options:
//    SBZ_MH3_CPL2_UP_TO    the k up to which a lane owns two columns.
//    SBZ_MH3_DEEP_UP_TO    the k up to which rows go three stages ahead.
//    SBZ_MH3_WAVES2_UP_TO  the k up to which the chunks fill the resident
//                          block slots twice over (above: once).
//    SBZ_MH3_CPL4_UP_TO    the k up to which a lane owns four columns.
//    SBZ_MH3_CLOCKS        as SBZ_MH2_CLOCKS.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SBZ_MH_DESIGN
#define SBZ_MH_DESIGN 3
#endif
#ifndef SBZ_MH_BITS
#define SBZ_MH_BITS 1
#endif
#ifndef SBZ_MH_EARLY
#define SBZ_MH_EARLY 1
#endif
#ifndef SBZ_MH_WAVES
#define SBZ_MH_WAVES 2
#endif
#ifndef SBZ_MH_NBUF
#define SBZ_MH_NBUF 4
#endif
#ifndef SBZ_MH2_SELECT
#define SBZ_MH2_SELECT 0
#endif
#ifndef SBZ_MH2_WAVES
#define SBZ_MH2_WAVES 2
#endif
#ifndef SBZ_MH2_DEEP_UP_TO
#define SBZ_MH2_DEEP_UP_TO 32
#endif
#ifndef SBZ_MH2_CLOCKS
#define SBZ_MH2_CLOCKS 0
#endif
#ifndef SBZ_MH3_CPL2_UP_TO
#define SBZ_MH3_CPL2_UP_TO 64
#endif
#ifndef SBZ_MH3_DEEP_UP_TO
#define SBZ_MH3_DEEP_UP_TO 32
#endif
#ifndef SBZ_MH3_WAVES2_UP_TO
#define SBZ_MH3_WAVES2_UP_TO -1
#endif
#ifndef SBZ_MH3_CPL4_UP_TO
#define SBZ_MH3_CPL4_UP_TO -1
#endif
#ifndef SBZ_MH3_CLOCKS
#define SBZ_MH3_CLOCKS 0
#endif

namespace {

constexpr float BIG = 1.0e30f;

#if SBZ_MH_DESIGN == 0
// ---------------------------------------------------------------- design 0
constexpr int TH = 16;
constexpr int TW = 32;
constexpr int NT = TH * TW;

__global__ void __launch_bounds__(NT)
min_haversine_kernel(const float* __restrict__ cpad,
                     const float* __restrict__ sdphi2,
                     const float* __restrict__ po,
                     const float* __restrict__ sdlam2,
                     float* __restrict__ out, int h, int w, int k) {
  const int nwin = 2 * k + 1;
  const int SH = TH + 2 * k, SW = TW + 2 * k;
  const int ph = h + 2 * k, pw = w + 2 * k;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;

  extern __shared__ float smem[];
  float* s_c = smem;
  float* s_m = s_c + SH * SW;
  float* s_l = s_m + SH * TW;
  float* s_s = s_l + nwin * TW;
  float* s_p = s_s + TH * nwin;

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
    s_l[dj * TW + xx] = c0 + xx < w ? sdlam2[(size_t)c0 * nwin + i] : BIG;
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
  for (int r = ty; r < SH; r += TH) {
    const float* row = s_c + r * SW + tx;
    float m = BIG;
    for (int dj = 0; dj < nwin; ++dj) {
      if (row[dj] > 0.0f) m = fminf(m, s_l[dj * TW + tx]);
    }
    s_m[r * TW + tx] = m;
  }
  __syncthreads();
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

size_t smem_bytes(int k) {
  const size_t nwin = 2 * (size_t)k + 1;
  const size_t sh = TH + 2 * (size_t)k, sw = TW + 2 * (size_t)k;
  return sizeof(float) * (sh * sw + sh * TW + nwin * TW + 2 * TH * nwin);
}

}  // namespace

extern "C" int sbz_min_haversine_limits(int* max_k) {
  int k = 0;
  while (smem_bytes(k + 1) <= 232448) ++k;
  *max_k = k;
  return 0;
}

extern "C" int sbz_min_haversine(const float* cpad, const float* sdphi2,
                                 const float* po, const float* sdlam2,
                                 const unsigned char*, float* out, int h,
                                 int w, int k,
                                 void* stream) {
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        min_haversine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
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

#elif SBZ_MH_DESIGN == 1
// ---------------------------------------------------------------- design 1
constexpr int TW = 32;          // band columns: one lane each
constexpr int S = 8;            // warps per block = padded rows per stage
constexpr int NT = TW * S;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold

__host__ __device__ constexpr int row_floats(int k) {
  return (TW + 2 * k + 3 + 3) & ~3;
}
__host__ __device__ constexpr int row_words(int k) {
  return (TW + 2 * k + 31) >> 5;
}
__host__ __device__ constexpr int ring_rows(int k) { return 2 * k + 2 * S; }

constexpr size_t smem_bytes(int k, int nbuf) {
  return sizeof(float) *
         ((size_t)(2 * k + 1) * TW + (size_t)ring_rows(k) * TW +
          (size_t)S * nbuf * row_floats(k) + (size_t)S * row_words(k) + 4);
}

constexpr int max_k() {
  int k = 0;
  while (smem_bytes(k + 1, 2) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_K = max_k();

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float tap(float sd, float p, float lo) {
  const float cand = __fadd_rn(sd, __fmul_rn(p, lo));
  return lo > 0.5f * BIG ? BIG : cand;
}

template <int NBUF>
__global__ void __launch_bounds__(NT)
min_haversine_kernel(const float* __restrict__ cpad,
                     const float* __restrict__ sdphi2,
                     const float* __restrict__ po,
                     const float* __restrict__ sdlam2,
                     const unsigned char* __restrict__ row_mono,
                     const unsigned char* __restrict__ col_mono,
                     float* __restrict__ out, int h, int w, int k, int ch) {
  const int nwin = 2 * k + 1, pw = w + 2 * k, win = TW + 2 * k;
  const int nring = ring_rows(k), rowf = row_floats(k), nw = row_words(k);
  const long long total = (long long)(h + 2 * k) * pw;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * ch;
  const int r1 = min(r0 + ch, h);
  const int nrows = r1 - r0 + 2 * k;     // padded rows this block sweeps
  const int nst = (nrows + S - 1) / S;
  const int x = c0 + lane;
  const bool xin = x < w;
  const int valid = min(win, pw - c0);   // window columns inside the field

  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);   // nwin x TW, transposed
  float* ring = slab + nwin * TW;                  // nring x TW
  float* rowb = ring + nring * TW + wid * NBUF * rowf;  // NBUF x rowf
  unsigned* words =
      reinterpret_cast<unsigned*>(slab + nwin * TW + nring * TW +
                                  S * NBUF * rowf) + wid * nw;
  int* last_coast = reinterpret_cast<int*>(words - wid * nw + S * nw);

  // Copies padded row pr's window into buf, in 16-byte pieces from the
  // 16-byte boundary at or before its first cell; pieces that leave the
  // array are read cell by cell.
  auto issue = [&](int pr, float* buf) {
    const long long g0 = (long long)pr * pw + c0;
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
  };

  for (int i = threadIdx.x; i < TW * nwin; i += NT) {
    const int xx = i / nwin, dj = i - xx * nwin;
    slab[dj * TW + xx] = c0 + xx < w ? sdlam2[(size_t)c0 * nwin + i] : BIG;
  }
  if (threadIdx.x == 0) *last_coast = r0 - 1;
  const bool cmono = SBZ_MH_BITS && col_mono != nullptr && xin &&
                     col_mono[x] != 0;
#pragma unroll
  for (int t = 0; t < NBUF - 1; ++t) {
    if (t * S + wid < nrows) issue(r0 + t * S + wid, rowb + t * rowf);
    cp_async_commit();
  }
  __syncthreads();

  for (int s = 0; s <= nst; ++s) {
    // ---- pass 1 on padded row r0 + s*S + wid
    if (s < nst) {
      const int t = s + NBUF - 1;
      if (t < nst && t * S + wid < nrows)
        issue(r0 + t * S + wid, rowb + (t % NBUF) * rowf);
      cp_async_commit();
      cp_async_wait<NBUF - 1>();
      __syncwarp();
      const int rr = s * S + wid;
      if (rr < nrows) {
        const int pr = r0 + rr;
        const float* buf = rowb + (s % NBUF) * rowf;
        const int o = (int)((reinterpret_cast<uintptr_t>(
                                 cpad + (long long)pr * pw + c0) >> 2) & 3);
        unsigned any = 0;
        for (int j = 0; j < nw; ++j) {
          const int c = 32 * j + lane;
          const unsigned m =
              __ballot_sync(~0u, c < valid && buf[o + c] > 0.0f);
          if (lane == 0) words[j] = m;
          any |= m;
        }
        __syncwarp();
        float m = BIG;
        if (any) {
#if SBZ_MH_BITS
          const int p = lane + k, hi = lane + 2 * k;
          if (cmono) {
            // nearest coast at or left of the centre, then at or right
            int wi = p >> 5;
            unsigned b = words[wi] & (0xFFFFFFFFu >> (31 - (p & 31)));
            while (!b && wi > 0) b = words[--wi];
            if (b) {
              const int L = (wi << 5) + 31 - __clz(b);
              if (L >= lane) m = slab[(L - lane) * TW + lane];
            }
            wi = p >> 5;
            b = words[wi] & (0xFFFFFFFFu << (p & 31));
            while (!b && wi < (hi >> 5)) b = words[++wi];
            if (b) {
              const int R = (wi << 5) + __ffs(b) - 1;
              if (R <= hi) m = fminf(m, slab[(R - lane) * TW + lane]);
            }
          } else {
            for (int wi = 0; wi <= (hi >> 5); ++wi) {
              unsigned b = words[wi];
              if (wi == 0) b &= 0xFFFFFFFFu << lane;
              if (wi == (hi >> 5)) b &= 0xFFFFFFFFu >> (31 - (hi & 31));
              while (b) {
                const int c = (wi << 5) + __ffs(b) - 1;
                b &= b - 1;
                m = fminf(m, slab[(c - lane) * TW + lane]);
              }
            }
          }
#else
          for (int dj = 0; dj < nwin; ++dj) {
            const int c = lane + dj;
            if ((words[c >> 5] >> (c & 31)) & 1u)
              m = fminf(m, slab[dj * TW + lane]);
          }
#endif
        }
        ring[(rr % nring) * TW + lane] = m;
        if (__any_sync(~0u, m < 0.5f * BIG) && lane == 0)
          atomicMax(last_coast, pr);
      }
    }

    // ---- pass 2 on output row y, whose window ended in stage s - 1
    const int y = r0 + (s - 1) * S + wid - 2 * k;
    if (s >= 1 && y >= r0 && y < r1) {
      float amin = BIG;
      if (*reinterpret_cast<volatile int*>(last_coast) >= y) {
        const float* sp = sdphi2 + (size_t)y * nwin;
        const float* pp = po + (size_t)y * nwin;
        const int base = (y - r0) % nring;     // ring slot of padded row y
#if SBZ_MH_EARLY
        if (row_mono != nullptr && row_mono[y] != 0) {
          // outward from the centre row y + k; the table grows outward on
          // both sides, and a candidate is never below its sdphi2 tap, so
          // once both taps of a step are >= every lane's best, no later
          // tap can win
          int sc = base + k;
          if (sc >= nring) sc -= nring;
          float a0 = tap(__ldg(sp + k), __ldg(pp + k), ring[sc * TW + lane]);
          float a1 = BIG;
          for (int j = 1; j <= k; ++j) {
            if ((j & 3) == 1) {
              const float lb = fminf(__ldg(sp + k - j), __ldg(sp + k + j));
              if (__all_sync(~0u, !xin || lb >= fminf(a0, a1))) break;
            }
            int su = sc - j, sd = sc + j;
            if (su < 0) su += nring;
            if (sd >= nring) sd -= nring;
            a0 = fminf(a0, tap(__ldg(sp + k - j), __ldg(pp + k - j),
                               ring[su * TW + lane]));
            a1 = fminf(a1, tap(__ldg(sp + k + j), __ldg(pp + k + j),
                               ring[sd * TW + lane]));
          }
          amin = fminf(a0, a1);
        } else
#endif
        {
          const int first = min(nwin, nring - base);
          const float* rg = ring + base * TW + lane;
          float a0 = BIG, a1 = BIG;
          int di = 0;
          for (; di + 1 < first; di += 2) {
            a0 = fminf(a0, tap(__ldg(sp + di), __ldg(pp + di), rg[di * TW]));
            a1 = fminf(a1, tap(__ldg(sp + di + 1), __ldg(pp + di + 1),
                               rg[(di + 1) * TW]));
          }
          for (; di < first; ++di)
            a0 = fminf(a0, tap(__ldg(sp + di), __ldg(pp + di), rg[di * TW]));
          rg = ring + lane - first * TW;
          for (; di < nwin; ++di)
            a1 = fminf(a1, tap(__ldg(sp + di), __ldg(pp + di), rg[di * TW]));
          amin = fminf(a0, a1);
        }
      }
      if (xin) out[(size_t)y * w + x] = amin;
    }
    __syncthreads();
  }
}

template <int NBUF>
int launch(const float* cpad, const float* sdphi2, const float* po,
           const float* sdlam2, const unsigned char* row_mono,
           const unsigned char* col_mono, float* out, int h, int w, int k,
           cudaStream_t stream) {
  auto kernel = min_haversine_kernel<NBUF>;
  const size_t smem = smem_bytes(k, NBUF);
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
  // chunk height: the bands times the chunks fill the resident block
  // slots SBZ_MH_WAVES times over
  const int bands = (w + TW - 1) / TW;
  const long long slots =
      (long long)SBZ_MH_WAVES * sms * (per_sm > 0 ? per_sm : 1);
  int ch = (int)(((long long)h * bands + slots - 1) / slots);
  ch = ch < S ? S : ch;
  ch = ch > h ? h : ch;
  const dim3 grid(bands, (h + ch - 1) / ch);
  kernel<<<grid, NT, smem, stream>>>(cpad, sdphi2, po, sdlam2, row_mono,
                                     col_mono, out, h, w, k, ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sbz_min_haversine_limits(int* max_k) {
  *max_k = MAX_K;
  return 0;
}

// marks the interface with row flags
extern "C" int sbz_min_haversine_row_flags() { return 0; }

extern "C" int sbz_min_haversine(const float* cpad, const float* sdphi2,
                                 const float* po, const float* sdlam2,
                                 const unsigned char* row_mono,
                                 const unsigned char* col_mono, float* out,
                                 int h, int w, int k, void* stream) {
  if (k < 0 || k > MAX_K || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (SBZ_MH_NBUF >= 4 && smem_bytes(k, 4) <= SMEM_OPTIN)
    return launch<4>(cpad, sdphi2, po, sdlam2, row_mono, col_mono, out, h, w,
                     k, s);
  return launch<2>(cpad, sdphi2, po, sdlam2, row_mono, col_mono, out, h, w,
                   k, s);
}

#elif SBZ_MH_DESIGN == 2
// ---------------------------------------------------------------- design 2
constexpr int TW = 32;              // band columns: one lane each
constexpr int S = 8;                // warps per block = padded rows a stage
constexpr int NT = TW * S;
constexpr int WAVES = SBZ_MH2_WAVES;
constexpr int DEEP_UP_TO = SBZ_MH2_DEEP_UP_TO;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold

// floats of one coast row buffer: the window and up to 3 cells before it
__host__ __device__ constexpr int row_floats(int k) {
  return (TW + 2 * k + 3 + 3) & ~3;
}
__host__ __device__ constexpr int row_words(int k) {
  return (TW + 2 * k + 31) >> 5;
}
__host__ __device__ constexpr int ring_rows(int k) { return 2 * k + 2 * S; }

// the ring, then per warp nbuf coast rows, nbuf (sdphi2, po) rows and the
// bit words, and the last coast row
constexpr size_t smem_bytes(int k, int nbuf) {
  return sizeof(float) *
         ((size_t)ring_rows(k) * TW +
          (size_t)S * nbuf * (row_floats(k) + 2 * (2 * k + 1)) +
          (size_t)S * row_words(k) + 4);
}

constexpr int max_k() {
  int k = 0;
  while (smem_bytes(k + 1, 2) <= SMEM_OPTIN) ++k;
  return k;
}
constexpr int MAX_K = max_k();

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

#if SBZ_MH2_CLOCKS
// cycles summed over warps: copies issued and awaited, pass 1, pass 2,
// the barrier; then over blocks: their cycles, the most of one block, and
// the blocks
__device__ unsigned long long g_clocks[7];
#define SBZ_CLK(v) const long long v = clock64()
#else
#define SBZ_CLK(v)
#endif

__device__ __forceinline__ float tap(float2 t, float lo) {
#if SBZ_MH2_SELECT
  const float cand = __fadd_rn(t.x, __fmul_rn(t.y, lo));
  return lo > 0.5f * BIG ? BIG : cand;
#else
  return __fadd_rn(t.x, __fmul_rn(t.y, lo));
#endif
}

// NBUF: buffers per warp (rows in flight: NBUF - 1 stages ahead)
template <int NBUF>
__global__ void __launch_bounds__(NT)
min_haversine_kernel(const float* __restrict__ cpad,
                     const float* __restrict__ sdphi2,
                     const float* __restrict__ po,
                     const float* __restrict__ sdlam2,
                     const unsigned char* __restrict__ col_mono,
                     float* __restrict__ out, int h, int w, int k, int ch) {
  const int nwin = 2 * k + 1, pw = w + 2 * k, win = TW + 2 * k;
  const int nring = ring_rows(k), rowf = row_floats(k), nw = row_words(k);
  const long long total = (long long)(h + 2 * k) * pw;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * ch;
  const int r1 = min(r0 + ch, h);
  const int nrows = r1 - r0 + 2 * k;     // padded rows this block sweeps
  const int nst = (nrows + S - 1) / S;
  const int x = c0 + lane;
  const bool xin = x < w;
  const int valid = min(win, pw - c0);   // window columns inside the field

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);          // nring x TW
  float* rows = ring + nring * TW;                        // S x NBUF x rowf
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

  SBZ_CLK(t_begin);
#if SBZ_MH2_CLOCKS
  long long c_wait = 0, c_p1 = 0, c_p2 = 0, c_bar = 0;
#endif
  if (threadIdx.x == 0) *last_coast = r0 - 1;
  const bool cmono = col_mono != nullptr && xin && col_mono[x] != 0;
  const float* lam = sdlam2 + (size_t)x * nwin;
#pragma unroll
  for (int t = 0; t < NBUF - 1; ++t) {
    issue(t);
    cp_async_commit();
  }
  __syncthreads();

  for (int s = 0; s <= nst; ++s) {
    SBZ_CLK(t0);
    issue(s + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();
    __syncwarp();
    SBZ_CLK(t1);

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
      float m = SBZ_MH2_SELECT ? BIG : INFINITY;
      if (any && xin) {
        const int p = lane + k, hi = lane + 2 * k;  // centre, window end
        if (cmono) {
          // the nearest coast at or left of the centre, then at or right
          int wi = p >> 5;
          unsigned b = words[wi] & (0xFFFFFFFFu >> (31 - (p & 31)));
          while (!b && wi > 0) b = words[--wi];
          if (b) {
            const int c = (wi << 5) + 31 - __clz(b);
            if (c >= lane) m = __ldg(lam + c - lane);
          }
          wi = p >> 5;
          b = words[wi] & (0xFFFFFFFFu << (p & 31));
          while (!b && wi < (hi >> 5)) b = words[++wi];
          if (b) {
            const int c = (wi << 5) + __ffs(b) - 1;
            if (c <= hi) m = fminf(m, __ldg(lam + c - lane));
          }
        } else {
          for (int wi = 0; wi <= (hi >> 5); ++wi) {
            unsigned b = words[wi];
            if (wi == 0) b &= 0xFFFFFFFFu << lane;
            if (wi == (hi >> 5)) b &= 0xFFFFFFFFu >> (31 - (hi & 31));
            while (b) {
              const int c = (wi << 5) + __ffs(b) - 1;
              b &= b - 1;
              m = fminf(m, __ldg(lam + c - lane));
            }
          }
        }
      }
      ring[(rr % nring) * TW + lane] = m;
      if (__any_sync(~0u, m < 0.5f * BIG) && lane == 0)
        atomicMax(last_coast, pr);
    }

    SBZ_CLK(t2);
    // ---- pass 2 on output row y, whose last window row was in stage s-1
    // (last_coast may already count this stage's rows: a later row only
    // keeps a row from being skipped)
    const int y = r0 + (s - 1) * S + wid - 2 * k;
    if (s >= 1 && y >= r0 && y < r1) {
      float amin = BIG;
      if (*reinterpret_cast<volatile int*>(last_coast) >= y) {
        const float2* tb = tabb + (s % NBUF) * nwin;
        const int base = (y - r0) % nring;     // ring slot of padded row y
        const int first = min(nwin, nring - base);
        const float* rg = ring + base * TW + lane;
        float a0 = BIG, a1 = BIG, a2 = BIG, a3 = BIG;
        int di = 0;
        for (; di + 3 < first; di += 4) {
          a0 = fminf(a0, tap(tb[di], rg[di * TW]));
          a1 = fminf(a1, tap(tb[di + 1], rg[(di + 1) * TW]));
          a2 = fminf(a2, tap(tb[di + 2], rg[(di + 2) * TW]));
          a3 = fminf(a3, tap(tb[di + 3], rg[(di + 3) * TW]));
        }
        for (; di < first; ++di) a0 = fminf(a0, tap(tb[di], rg[di * TW]));
        rg = ring + lane - first * TW;         // past the ring's end
        for (; di + 3 < nwin; di += 4) {
          a0 = fminf(a0, tap(tb[di], rg[di * TW]));
          a1 = fminf(a1, tap(tb[di + 1], rg[(di + 1) * TW]));
          a2 = fminf(a2, tap(tb[di + 2], rg[(di + 2) * TW]));
          a3 = fminf(a3, tap(tb[di + 3], rg[(di + 3) * TW]));
        }
        for (; di < nwin; ++di) a0 = fminf(a0, tap(tb[di], rg[di * TW]));
        amin = fminf(fminf(a0, a1), fminf(a2, a3));
      }
      if (xin) out[(size_t)y * w + x] = amin;
    }
    SBZ_CLK(t3);
    __syncthreads();
#if SBZ_MH2_CLOCKS
    const long long t4 = clock64();
    c_wait += t1 - t0;
    c_p1 += t2 - t1;
    c_p2 += t3 - t2;
    c_bar += t4 - t3;
#endif
  }
#if SBZ_MH2_CLOCKS
  if (lane == 0) {
    atomicAdd(&g_clocks[0], (unsigned long long)c_wait);
    atomicAdd(&g_clocks[1], (unsigned long long)c_p1);
    atomicAdd(&g_clocks[2], (unsigned long long)c_p2);
    atomicAdd(&g_clocks[3], (unsigned long long)c_bar);
  }
  if (threadIdx.x == 0) {
    const unsigned long long c = clock64() - t_begin;
    atomicAdd(&g_clocks[4], c);
    atomicMax(&g_clocks[5], c);
    atomicAdd(&g_clocks[6], 1ull);
  }
#endif
}

template <int NBUF>
int launch(const float* cpad, const float* sdphi2, const float* po,
           const float* sdlam2, const unsigned char* col_mono, float* out,
           int h, int w, int k, cudaStream_t stream) {
  auto kernel = min_haversine_kernel<NBUF>;
  const size_t smem = smem_bytes(k, NBUF);
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
  const int bands = (w + TW - 1) / TW;
  const long long slots = (long long)WAVES * sms * (per_sm > 0 ? per_sm : 1);
  int ch = (int)(((long long)h * bands + slots - 1) / slots);
  ch = ch < S ? S : ch;
  ch = ch > h ? h : ch;
  const dim3 grid(bands, (h + ch - 1) / ch);
  kernel<<<grid, NT, smem, stream>>>(cpad, sdphi2, po, sdlam2, col_mono, out,
                                     h, w, k, ch);
  return (int)cudaGetLastError();
}

}  // namespace

#if SBZ_MH2_CLOCKS
// the counters since the last call (then zeroed), in host memory
extern "C" int sbz_min_haversine_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[7] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks));
  return (int)err;
}
#endif

// The widest k the kernel takes.
extern "C" int sbz_min_haversine_limits(int* max_k) {
  *max_k = MAX_K;
  return 0;
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
    return launch<4>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, s);
  return launch<2>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k, s);
}

#else
// ---------------------------------------------------------------- design 3
constexpr int S = 8;                // warps per block = padded rows a stage
constexpr int NT = 32 * S;
constexpr int SMEM_OPTIN = 232448;  // shared memory one block may hold
// Up to these k: two columns a lane (bands of 64); rows copied three
// stages ahead; blocks filling the resident block slots twice over.
// Above: one column a lane (bands of 32, half the ring); one stage ahead;
// once over (fewer halo rows per chunk).
constexpr int CPL2_UP_TO = SBZ_MH3_CPL2_UP_TO;
constexpr int DEEP_UP_TO = SBZ_MH3_DEEP_UP_TO;
constexpr int WAVES2_UP_TO = SBZ_MH3_WAVES2_UP_TO;
constexpr int CPL4_UP_TO = SBZ_MH3_CPL4_UP_TO;

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

#if SBZ_MH3_CLOCKS
// cycles summed over warps: copies issued and awaited, pass 1, pass 2,
// the barrier; then over blocks: their cycles, the most of one block, and
// the blocks
__device__ unsigned long long g_clocks[7];
#define SBZ_CLK(v) const long long v = clock64()
#else
#define SBZ_CLK(v)
#endif

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

  SBZ_CLK(t_begin);
#if SBZ_MH3_CLOCKS
  long long c_wait = 0, c_p1 = 0, c_p2 = 0, c_bar = 0;
#endif
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
    SBZ_CLK(t0);
    issue(s + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();
    __syncwarp();
    SBZ_CLK(t1);

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
    SBZ_CLK(t2);

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
    SBZ_CLK(t3);
    __syncthreads();
#if SBZ_MH3_CLOCKS
    const long long t4 = clock64();
    c_wait += t1 - t0;
    c_p1 += t2 - t1;
    c_p2 += t3 - t2;
    c_bar += t4 - t3;
#endif
  }
#if SBZ_MH3_CLOCKS
  if (lane == 0) {
    atomicAdd(&g_clocks[0], (unsigned long long)c_wait);
    atomicAdd(&g_clocks[1], (unsigned long long)c_p1);
    atomicAdd(&g_clocks[2], (unsigned long long)c_p2);
    atomicAdd(&g_clocks[3], (unsigned long long)c_bar);
  }
  if (threadIdx.x == 0) {
    const unsigned long long c = clock64() - t_begin;
    atomicAdd(&g_clocks[4], c);
    atomicMax(&g_clocks[5], c);
    atomicAdd(&g_clocks[6], 1ull);
  }
#endif
}

template <int NBUF, int CPL>
int launch(const float* cpad, const float* sdphi2, const float* po,
           const float* sdlam2, const unsigned char* col_mono, float* out,
           int h, int w, int k, int waves, cudaStream_t stream) {
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
  // slots `waves` times over
  const int bands = (w + 32 * CPL - 1) / (32 * CPL);
  const long long slots = (long long)waves * sms * (per_sm > 0 ? per_sm : 1);
  int ch = (int)(((long long)h * bands + slots - 1) / slots);
  ch = ch < S ? S : ch;
  ch = ch > h ? h : ch;
  const dim3 grid(bands, (h + ch - 1) / ch);
  kernel<<<grid, NT, smem, stream>>>(cpad, sdphi2, po, sdlam2, col_mono, out,
                                     h, w, k, ch);
  return (int)cudaGetLastError();
}

}  // namespace

#if SBZ_MH3_CLOCKS
// the counters since the last call (then zeroed), in host memory
extern "C" int sbz_min_haversine_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[7] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks));
  return (int)err;
}
#endif

// The widest k the kernel takes.
extern "C" int sbz_min_haversine_limits(int* max_k) {
  *max_k = MAX_K;
  return 0;
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
  const int waves = k <= WAVES2_UP_TO ? 2 : 1;
  const bool deep = k <= DEEP_UP_TO;
  if (k <= CPL4_UP_TO)
    return deep ? launch<4, 4>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w,
                               k, waves, s)
                : launch<2, 4>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w,
                               k, waves, s);
  if (k <= CPL2_UP_TO)
    return deep ? launch<4, 2>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w,
                               k, waves, s)
                : launch<2, 2>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w,
                               k, waves, s);
  return deep ? launch<4, 1>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k,
                             waves, s)
              : launch<2, 1>(cpad, sdphi2, po, sdlam2, col_mono, out, h, w, k,
                             waves, s);
}

#endif
