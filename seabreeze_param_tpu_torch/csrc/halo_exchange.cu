// Kernel B6: the halo exchange of a decomposed run, for Hopper.
//
// Replaces seabreeze_param_tpu/ops/pallas/halo_kernel.py::halo_strips_dma
// (body _kernel) and its drop-in halo_exchange_dma.  Plain version:
// seabreeze_param_tpu_torch/parallel/halo.py::halo_exchange_plain.
//
// Given the S = py * px source blocks of a mesh, each (C, h, w) float32,
// write S padded blocks (C, h + 2hy, w + 2hx): the centre, the two lon
// strips (lon is a ring), the lat strips and the corners from the
// neighbours (lat is bounded; corners come straight from the diagonal
// neighbour), and on the global lat edges the fill: copies of the edge row
// ('clamp') or zeros ('zero').  With exact_lon, the reference's quirky lon
// seam: padded position -1 of the first mesh column and interior position
// n-1 of the last both read global column 0.
//
// In a multi-process run each process holds a block of whole mesh rows and
// the lat strips of its edge rows come from the neighbouring processes:
// given a strip (C, hy, px * w) of the neighbour's boundary rows at full
// width for the top or the bottom (sbz_halo_exchange_range), the rows
// beyond that edge take it in place of the fill, its columns ringed and
// seam-patched as a neighbour shard's would be.
//
// The TPU kernel runs once per chip and pushes its strips into the
// neighbours' buffers by remote DMA, after a barrier-semaphore round and
// with a collective id per channel, because every chip runs its own copy.
// Here one process drives every shard, and a mesh is split into groups of
// contiguous shards, each group on one card (parallel/mesh.py).  A launch
// serves one group: it writes the padded blocks of the group's shards
// [s0, s1) only, on the group's card and stream, and pulls what they need
// from any shard's source block: across cards through peer pointers (UVA,
// peer access enabled by sbz_enable_peer), so nothing is pushed and the
// pull takes the place of the remote DMA.  The barrier is the wrapper's:
// before the launch the group's stream waits on an event of each group it
// reads, recorded after their sources were written, and afterwards those
// groups' streams wait on the launch (ops/cuda/halo_kernel.py).  A mesh of
// one group is one launch for all shards and channels, ordered after the
// writes of its sources by the stream alone.  The shard pointers travel by
// value in the kernel's argument struct (up to kMaxShards), so no pointer
// table is copied to the device per call.
//
// What bounds it on an H100: device memory.  Every source float is read
// once and every padded float written once: 8.8 MB at the 0.25-degree
// shards (2 x 4 mesh, 361 x 360, a 10-wide halo), 2.6 us at 3.35 TB/s;
// 54 MB at 0.1 degree (901 x 900, 19 wide), 16 us.  The first design, one
// thread per destination float (tools/designs/halo_exchange_gather.cu),
// reached 0.6-1.0 TB/s: a block per kilobyte, four integer divisions and
// one 4-byte load in flight per thread.
//
// Design: rows, one warp each, on a grid sized to the card.
// * A work item is one padded row (shard, channel, row); each warp strides
//   over them.  Its source row (the lat neighbour, or the clamped edge
//   row, or none for a zero fill), the three source shards of its columns
//   (left halo, centre, right halo) and the seam slots are worked out once
//   per row, not per float.
// * The row is written in 16-byte units aligned in device memory, whatever
//   the row's own alignment (the 0.1-degree row stride, 3752 bytes, is no
//   multiple of 16).  The units wholly inside the centre span take their
//   four floats from one source row: each lane loads the one or two
//   aligned 16-byte source chunks that hold them (two where the source and
//   destination differ in their offset modulo 16 bytes; the second chunk is
//   the next lane's first, so L1 serves it) and shifts them into place in
//   registers.  Four units per lane are loaded before any is stored.
// * The rest of the row (both halo strips, the corners, the seam slots and
//   the centre's unaligned ends, 2hx + 0..7 floats) goes one float per lane
//   through the same per-row sources.
// * A zero-fill row loads nothing.
// Measured on an H100 (PERF.md): as fast as a Tensor.copy_ of the bytes it
// writes, at 0.55 of the bound at 0.1 degree and half the first design's
// time, at 103 registers (two blocks per SM).  Held to 64 registers (four
// blocks per SM) or with two units in flight a lane it was slower
// (tools/designs/halo_exchange_rows_variants.cu).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int NT = 256;      // threads per block
constexpr int UNROLL = 4;    // 16-byte units per lane loaded before a store

// Every shard's source block, and the destination blocks of the launch's
// `shards` shards from Geometry::s0 on.
struct ShardPtrs {
  const float* src[kMaxShards];
  float* dst[kMaxShards];
  int shards;
};

// The strips of a process edge (top, bottom), or null where the edge is
// global.
struct Edges {
  const float* strip[2];
};

// s0: the first destination shard of the launch's group.
struct Geometry {
  int py, px, c, h, w, hy, hx, zero_fill, exact_lon, s0;
};

// Four consecutive floats starting `sh` floats into the 8 of (lo, hi).
__device__ __forceinline__ float4 shift4(const float4& lo, const float4& hi,
                                         int sh) {
  switch (sh) {
    case 0: return lo;
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    default: return make_float4(lo.w, hi.x, hi.y, hi.z);
  }
}

// EDGES: a block of a multi-process mesh, some of whose lat edges take a
// strip.  A build of its own: the per-row check for a strip slowed the
// exchange of a whole mesh by 7-11% when both shared one (PERF.md).
template <bool EDGES>
__global__ void __launch_bounds__(NT, 1)
halo_rows(const ShardPtrs p, const Geometry g, const Edges e) {
  const int hp = g.h + 2 * g.hy, wp = g.w + 2 * g.hx;
  const int nlat = g.py * g.h;
  const int per_shard = g.c * hp;
  const int rows = p.shards * per_shard;
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (NT / 32);

  for (int row = blockIdx.x * (NT / 32) + threadIdx.x / 32; row < rows;
       row += warps) {
    // the row's sources, once per row
    const int sl = row / per_shard, rr = row - sl * per_shard;
    const int s = g.s0 + sl;
    const int ch = rr / hp, r = rr - ch * hp;
    const int iy = s / g.px, ix = s - iy * g.px;
    int gy = iy * g.h + r - g.hy;
    bool zero = false;
    const float *C, *L, *R;
    const float* edge = nullptr;
    if constexpr (EDGES)
      edge = gy < 0 ? e.strip[0] : gy >= nlat ? e.strip[1] : nullptr;
    if (EDGES && edge) {  // a process edge: row gy of the neighbour's strip
      const int er = gy < 0 ? gy + g.hy : gy - nlat;
      const float* row = edge + ((size_t)ch * g.hy + er) *
                                    ((size_t)g.px * g.w);
      C = row + (size_t)ix * g.w;
      L = row + (size_t)(ix == 0 ? g.px - 1 : ix - 1) * g.w;
      R = row + (size_t)(ix == g.px - 1 ? 0 : ix + 1) * g.w;
    } else {
      if (gy < 0 || gy >= nlat) {  // the global lat edge
        zero = g.zero_fill;
        gy = gy < 0 ? 0 : nlat - 1;
      }
      const int sy = gy / g.h, ly = gy - sy * g.h;
      const size_t off = ((size_t)ch * g.h + ly) * g.w;
      C = p.src[sy * g.px + ix] + off;
      L = p.src[sy * g.px + (ix == 0 ? g.px - 1 : ix - 1)] + off;
      R = p.src[sy * g.px + (ix == g.px - 1 ? 0 : ix + 1)] + off;
    }
    const bool seam_l = g.exact_lon && ix == 0;           // slot hx - 1
    const bool seam_r = g.exact_lon && ix == g.px - 1;    // slot hx + w - 1
    float* D = p.dst[sl] + (size_t)rr * wp;

    // the aligned units inside the centre span: columns u0, u0 + 4, ...
    // (u0 + 4n <= the span's end, the right seam slot left out)
    const int a = (int)((reinterpret_cast<uintptr_t>(D) >> 2) & 3);
    const int u0 = g.hx + ((4 - ((a + g.hx) & 3)) & 3);
    const int end = g.hx + g.w - (seam_r ? 1 : 0);
    const int n = end > u0 ? (end - u0) >> 2 : 0;
    const int v1 = u0 + 4 * n;
    // the source chunk of unit 0 and the shift into it
    const uintptr_t s0 = reinterpret_cast<uintptr_t>(C + (u0 - g.hx));
    const float4* Q = reinterpret_cast<const float4*>(s0 & ~uintptr_t(15));
    const int sh = (int)((s0 >> 2) & 3);
    float4* D4 = reinterpret_cast<float4*>(D + u0);

    // one float of the row's other columns
    auto one = [&](int col) -> float {
      if (zero) return 0.0f;
      if (col < g.hx) return seam_l && col == g.hx - 1 ? C[0]
                                                       : L[g.w - g.hx + col];
      col -= g.hx;
      if (col < g.w) return seam_r && col == g.w - 1 ? R[0] : C[col];
      return R[col - g.w];
    };

    for (int j0 = 0; j0 < n || j0 == 0; j0 += 32 * UNROLL) {
      float4 lo[UNROLL], hi[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        lo[u] = hi[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < n && !zero) {
          lo[u] = __ldg(Q + j);
          if (sh) hi[u] = __ldg(Q + j + 1);
        }
      }
      if (j0 == 0) {  // the other columns, while the first loads fly
        for (int col = lane; col < min(u0, wp); col += 32) D[col] = one(col);
        for (int col = v1 + lane; col < wp; col += 32) D[col] = one(col);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < n) D4[j] = shift4(lo[u], hi[u], sh);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// The persistent grid on the current device: the blocks the card holds at
// once, worked out at the first launch on each card and kept per card.
template <bool EDGES>
int resident_blocks() {
  static int blocks[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && blocks[dev]) return blocks[dev];
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, halo_rows<EDGES>,
                                                NT, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int b = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (dev < kMaxDevices) blocks[dev] = b;
  return b;
}

}  // namespace

// src: host array of the S = py * px shards' device pointers; dst: of
// the destination blocks of shards [s0, s1), the launch's group (dst[0]
// is shard s0's); top, bot: the device strips (c, hy, px * w) of a process
// edge on the launch's card, or null where the edge is global (the fill) or
// no shard of [s0, s1) lies on the block's first (top) or last (bot) mesh
// row; shard s reads the strip at its own mesh column's offset, (s % px) *
// w, whichever group it is in.  Launches on the
// current device, which holds the destination blocks.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for more than kMaxShards
// shards, an empty or out-of-mesh range, or a halo wider than the shard.
extern "C" int sbz_halo_exchange_range(const float* const* src,
                                       float* const* dst, int py, int px,
                                       int c, int h, int w, int hy, int hx,
                                       int zero_fill, int exact_lon,
                                       const float* top, const float* bot,
                                       int s0, int s1, void* stream) {
  const int shards = py * px;
  if (shards < 1 || shards > kMaxShards || hy < 0 || hy > h || hx < 0 ||
      hx > w || c < 1 || s0 < 0 || s1 <= s0 || s1 > shards)
    return (int)cudaErrorInvalidValue;
  ShardPtrs p;
  for (int s = 0; s < shards; ++s) p.src[s] = src[s];
  for (int s = s0; s < s1; ++s) p.dst[s - s0] = dst[s - s0];
  p.shards = s1 - s0;
  const Edges e{{top, bot}};
  // The seam patches exist only on a lon exchange (as in halo_finish).
  const Geometry g{py, px, c, h, w, hy, hx, zero_fill, exact_lon && hx > 0,
                   s0};
  const long long rows = (long long)p.shards * c * (h + 2 * hy);
  const long long need = (rows + NT / 32 - 1) / (NT / 32);
  const cudaStream_t st = (cudaStream_t)stream;
  if (top || bot) {
    const int resident = resident_blocks<true>();
    halo_rows<true><<<need < resident ? (int)need : resident, NT, 0, st>>>(
        p, g, e);
  } else {
    const int resident = resident_blocks<false>();
    halo_rows<false><<<need < resident ? (int)need : resident, NT, 0, st>>>(
        p, g, e);
  }
  return (int)cudaGetLastError();
}

// The exchange of a whole mesh: both lat edges global.
extern "C" int sbz_halo_exchange(const float* const* src, float* const* dst,
                                 int py, int px, int c, int h, int w, int hy,
                                 int hx, int zero_fill, int exact_lon,
                                 void* stream) {
  return sbz_halo_exchange_range(src, dst, py, px, c, h, w, hy, hx,
                                 zero_fill, exact_lon, nullptr, nullptr, 0,
                                 py * px, stream);
}

// Let kernels on card `dev` read card `peer`'s memory.  Already enabled
// counts as done (and the error it leaves is cleared, so the next launcher
// does not read it back as its own).  Restores the current device.
extern "C" int sbz_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}
