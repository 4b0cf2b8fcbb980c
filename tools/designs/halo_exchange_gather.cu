// Kernel B6, the first design (one thread per destination float): kept
// beside seabreeze_param_tpu_torch/csrc/halo_exchange.cu, with the same C
// interface (sbz_halo_exchange), so that tools/compare_designs.py can time
// the two side by side.  Same function, bit for bit.  Measured on an H100
// (PERF.md): 0.62 TB/s at the 0.25-degree shards, 0.97 TB/s at the
// 0.1-degree ones; every block moves 1 KB and each thread does up to four
// integer divisions for one 4-byte load.
//
// SBZ_HALO_ROWS (default 1): padded rows each thread copies, one after the
// other, so the grid has that many times fewer blocks while each thread
// still has one load in flight: it tells the cost of the blocks from that
// of the loads.
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
// The TPU kernel runs once per chip and pushes its strips into the
// neighbours' buffers by remote DMA, after a barrier-semaphore round and
// with a collective id per channel, because every chip runs its own copy.
// Here one process holds every shard on one card and stream order already
// orders the launch after the writes of its sources, so one launch serves
// all shards and all channels, with no barrier.
//
// Design: gather form.  One thread per destination element: from its
// shard (blockIdx.z), row and column it computes the global row (clamped or
// zero beyond the lat edges) and the global column (periodic, the two seam
// slots patched), hence the source shard and offset, and copies one float.
// So every destination element is written exactly once, the lat fills and
// the seam patches are folded into the same launch (no slot is left as
// torch.empty made it, and no torch op follows), and a warp reads and
// writes 32 neighbouring columns of one row.  The shard pointers travel by
// value in the kernel's argument struct (up to kMaxShards), so no pointer
// table is copied to the device per call.  The same gather reads a peer
// card's memory unchanged once the shards are spread over several cards.
//
// What bounds it on an H100: launch latency.  At global 0.25 deg on a 2 x 4
// mesh a 361 x 360 shard is 0.52 MB; the whole exchange moves about 4.2 MB
// of centres and 0.5 MB of strips at a 10-wide halo, about 3 us at the
// card's 3.35 TB/s, against a few us to launch.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int BX = 32;  // threads along the padded row
constexpr int BY = 8;   // padded rows per block
#ifndef SBZ_HALO_ROWS
#define SBZ_HALO_ROWS 1
#endif

struct ShardPtrs {
  const float* src[kMaxShards];
  float* dst[kMaxShards];
};

struct Geometry {
  int py, px, c, h, w, hy, hx, zero_fill, exact_lon;
};

__global__ void __launch_bounds__(BX * BY)
halo_kernel(const ShardPtrs p, const Geometry g) {
  const int s = blockIdx.z;
  const int iy = s / g.px, ix = s - iy * g.px;
  const int hp = g.h + 2 * g.hy, wp = g.w + 2 * g.hx;
  const int nlat = g.py * g.h, nlon = g.px * g.w;
  const int col = blockIdx.x * BX + threadIdx.x;
  if (col >= wp) return;

  // Global column of this padded column: periodic, with the quirky seam.
  int gx = ix * g.w + col - g.hx;
  if (g.exact_lon && ((ix == 0 && col == g.hx - 1) ||
                      (ix == g.px - 1 && col == g.hx + g.w - 1)))
    gx = 0;
  if (gx < 0) gx += nlon;
  else if (gx >= nlon) gx -= nlon;
  const int sx = gx / g.w, lx = gx - sx * g.w;

  float* dst = p.dst[s];
  for (int row = blockIdx.y * BY + threadIdx.y; row < g.c * hp;
       row += gridDim.y * BY) {
    const int ch = row / hp, r = row - ch * hp;
    int gy = iy * g.h + r - g.hy;
    float v = 0.0f;
    bool read = true;
    if (gy < 0 || gy >= nlat) {  // the global lat edge
      read = !g.zero_fill;
      gy = gy < 0 ? 0 : nlat - 1;
    }
    if (read) {
      const int sy = gy / g.h, ly = gy - sy * g.h;
      v = p.src[sy * g.px + sx][((size_t)ch * g.h + ly) * g.w + lx];
    }
    dst[(size_t)row * wp + col] = v;
  }
}

}  // namespace

// src, dst: host arrays of the S = py * px device pointers.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for more than kMaxShards
// shards or a halo wider than the shard.
extern "C" int sbz_halo_exchange(const float* const* src, float* const* dst,
                                 int py, int px, int c, int h, int w, int hy,
                                 int hx, int zero_fill, int exact_lon,
                                 void* stream) {
  const int shards = py * px;
  if (shards < 1 || shards > kMaxShards || hy < 0 || hy > h || hx < 0 ||
      hx > w || c < 1)
    return (int)cudaErrorInvalidValue;
  ShardPtrs p;
  for (int s = 0; s < shards; ++s) {
    p.src[s] = src[s];
    p.dst[s] = dst[s];
  }
  // The seam patches exist only on a lon exchange (as in halo_finish).
  const Geometry g{py, px, c, h, w, hy, hx, zero_fill, exact_lon && hx > 0};
  const int rows = c * (h + 2 * hy);
  int gy = (rows + BY * SBZ_HALO_ROWS - 1) / (BY * SBZ_HALO_ROWS);
  if (gy > 65535) gy = 65535;  // the kernel strides over the rest
  const dim3 grid((w + 2 * hx + BX - 1) / BX, gy, shards);
  halo_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(p, g);
  return (int)cudaGetLastError();
}
