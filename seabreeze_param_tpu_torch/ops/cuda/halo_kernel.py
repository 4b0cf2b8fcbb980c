"""Wrapper of kernel B6 (``csrc/halo_exchange.cu``), the halo exchange of
a decomposed run, replacing the JAX package's
``ops/pallas/halo_kernel.py::halo_exchange_dma`` (``halo_strips_dma``).
Plain version: ``parallel.halo.halo_exchange_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ...parallel.halo import check_exchange, halo_exchange_plain
from . import _build

#: The most shards one launch takes (kMaxShards in csrc/halo_exchange.cu).
MAX_SHARDS = 64


def halo_exchange_cuda(local, mesh, hy: int, hx: int, *,
                       lat_fill: str = "clamp", exact_lon: bool = True,
                       edges=(None, None)):
    """The padded ``(..., h + 2*hy, w + 2*hx)`` block of every shard.

    ``local`` — the ``mesh.size`` shards, one shape ``(h, w)`` or
    ``(C, h, w)``, float32, contiguous, on the mesh's device.  Lon is
    periodic; the global lat edges take ``lat_fill`` (``'clamp'`` or
    ``'zero'``); ``exact_lon`` applies the quirky seam patches.
    ``edges`` — ``(top, bot)``: for a process edge of a multi-process run,
    the neighbour's boundary rows ``(..., hy, px*w)`` that the rows beyond
    it take instead of the fill (``parallel.distributed.exchange_edges``);
    None at a global edge.  Returns a list of new tensors.

    CUDA tensors: ONE launch of B6 on the current stream, for every shard
    and channel, fills and patches included (counted in
    ``halo_exchange_cuda.launches``).  CPU tensors take the plain version.
    """
    hy, hx = int(hy), int(hx)
    if local[0].device.type == "cpu":
        return halo_exchange_plain(local, mesh, hy, hx, lat_fill=lat_fill,
                                   exact_lon=exact_lon, edges=edges)
    check_exchange(local, mesh, hy, hx, lat_fill)
    if mesh.size > MAX_SHARDS:
        raise ValueError(f"{mesh.size} shards: one launch takes at most "
                         f"{MAX_SHARDS}")
    dev = local[0].device
    shape = tuple(local[0].shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"shard shape {shape}: want (h, w) or (C, h, w)")
    for s, x in enumerate(local):
        _build.require(x, f"shard {s}", shape, dev)
    h, w = shape[-2:]
    c = shape[0] if len(shape) == 3 else 1
    for name, e in zip(("top", "bot"), edges):
        if e is not None:
            _build.require(e, f"{name} edge", shape[:-2] + (hy, mesh.px * w),
                           dev)
    # one allocation for every shard's block: each torch.empty costs the
    # host several microseconds, and the call is host-bound
    out = list(torch.empty((mesh.size,) + shape[:-2]
                           + (h + 2 * hy, w + 2 * hx),
                           dtype=torch.float32, device=dev).unbind(0))
    ptrs = ctypes.c_void_p * mesh.size
    src = ptrs(*(x.data_ptr() for x in local))
    dst = ptrs(*(o.data_ptr() for o in out))
    lib = _build.load()
    top, bot = (None if e is None else e.data_ptr() for e in edges)
    with torch.cuda.device(dev):
        err = lib.sbz_halo_exchange_edges(
            src, dst, mesh.py, mesh.px, c, h, w, hy, hx,
            int(lat_fill == "zero"), int(bool(exact_lon)), top, bot,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "halo_exchange_cuda")
    halo_exchange_cuda.launches += 1
    return out


halo_exchange_cuda.launches = 0
