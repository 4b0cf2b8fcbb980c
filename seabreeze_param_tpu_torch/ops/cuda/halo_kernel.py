"""Wrapper of kernel B6 (``csrc/halo_exchange.cu``), the halo exchange of
a decomposed run, replacing the JAX package's
``ops/pallas/halo_kernel.py::halo_exchange_dma`` (``halo_strips_dma``).
Plain version: ``parallel.halo.halo_exchange_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ...parallel.halo import check_exchange, group_edges, halo_exchange_plain
from ...parallel.mesh import fork, group_streams, join, source_groups
from . import _build

#: The most shards one launch takes (kMaxShards in csrc/halo_exchange.cu).
MAX_SHARDS = 64

#: (card, peer) pairs whose peer access this process has enabled.
_PEERS: set = set()


def _enable_peer(dev: torch.device, peer: torch.device):
    """Let kernels on card ``dev`` read card ``peer``'s memory; refuse a
    pair that cannot (B6 never stages through the host)."""
    if (dev.index, peer.index) in _PEERS:
        return
    if not torch.cuda.can_device_access_peer(dev, peer):
        raise RuntimeError(f"halo_exchange_cuda: {dev} cannot read {peer}'s "
                           f"memory (no peer access between the cards)")
    _build.check(_build.load().sbz_enable_peer(dev.index, peer.index),
                 "sbz_enable_peer")
    _PEERS.add((dev.index, peer.index))


def halo_exchange_cuda(local, mesh, hy: int, hx: int, *,
                       lat_fill: str = "clamp", exact_lon: bool = True,
                       edges=None):
    """The padded ``(..., h + 2*hy, w + 2*hx)`` block of every shard.

    ``local`` — the ``mesh.size`` shards, one shape ``(h, w)`` or
    ``(C, h, w)``, float32, contiguous, each on its group's device.  Lon
    is periodic; the global lat edges take ``lat_fill`` (``'clamp'`` or
    ``'zero'``); ``exact_lon`` applies the quirky seam patches.
    ``edges`` — ``{device: (top, bot)}``: for a process edge of a
    multi-process run, the neighbour's boundary rows ``(..., hy, px*w)``
    that the rows beyond it take instead of the fill, one copy on each card
    whose groups read it (``parallel.distributed.exchange_edges``); None at
    a global edge.  Each group's launch takes the copies on its own card,
    and none where its shards do not touch the block's first or last mesh
    row (``parallel.halo.group_edges``); an edge a group reads with no copy
    on its card is refused.  Returns a list of new tensors, each on its
    shard's device.

    CUDA tensors: one launch of B6 per group of the mesh, each for every
    shard of the group and every channel, fills and patches included
    (counted in ``halo_exchange_cuda.launches``).  A one-group mesh is ONE
    launch on the current stream.  Over several groups each launch runs
    on its group's device and stream (``parallel.mesh.group_streams``):
    the streams first wait on the cards' current streams, each launch
    waits on an event of every group it reads, recorded after their
    sources were written, reads sources on other cards through peer
    pointers, and those groups' streams then wait on it (so a source is
    neither rewritten nor freed for reuse before it was read); last the
    current streams wait on the groups.  CPU tensors take the plain
    version.
    """
    hy, hx = int(hy), int(hx)
    if local[0].device.type == "cpu":
        return halo_exchange_plain(local, mesh, hy, hx, lat_fill=lat_fill,
                                   exact_lon=exact_lon, edges=edges)
    check_exchange(local, mesh, hy, hx, lat_fill)
    if mesh.size > MAX_SHARDS:
        raise ValueError(f"{mesh.size} shards: one launch takes at most "
                         f"{MAX_SHARDS}")
    shape = tuple(local[0].shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"shard shape {shape}: want (h, w) or (C, h, w)")
    for s, x in enumerate(local):
        _build.require(x, f"shard {s}", shape, mesh.device_of(s))
    h, w = shape[-2:]
    per_group = [group_edges(edges, mesh, g) for g in range(mesh.groups)]
    for g, pair in enumerate(per_group):
        for name, e in zip(("top", "bot"), pair):
            if e is not None:
                _build.require(e, f"group {g}'s {name} edge",
                               shape[:-2] + (hy, mesh.px * w),
                               mesh.devices[g])
    args = (hy, hx, int(lat_fill == "zero"), int(bool(exact_lon)))
    src = (ctypes.c_void_p * mesh.size)(*(x.data_ptr() for x in local))
    if mesh.groups == 1:
        return _launch(src, mesh, shape, args, per_group[0],
                       mesh.group_shards(0))
    streams = group_streams(mesh)
    for g, dev in enumerate(mesh.devices):
        for j in source_groups(mesh, g):
            if mesh.devices[j] != dev:
                _enable_peer(dev, mesh.devices[j])
    fork(mesh)
    ready = [st.record_event() for st in streams]
    out = []
    for g, st in enumerate(streams):
        for j in source_groups(mesh, g):
            if j != g:
                st.wait_event(ready[j])
        with torch.cuda.stream(st):
            out += _launch(src, mesh, shape, args, per_group[g],
                           mesh.group_shards(g))
    done = [st.record_event() for st in streams]
    for g in range(mesh.groups):
        for j in source_groups(mesh, g):
            if j != g:
                streams[j].wait_event(done[g])
    join(mesh)
    return out


def _launch(src, mesh, shape, args, edges, shards: range):
    """One launch of B6 writing the padded blocks of ``shards`` (one
    group's) on their device's current stream, ``edges`` the group's
    ``(top, bot)`` strips on that device; returns them."""
    hy, hx = args[:2]
    h, w = shape[-2:]
    c = shape[0] if len(shape) == 3 else 1
    dev = mesh.device_of(shards.start)
    # one allocation for the group's blocks: each torch.empty costs the
    # host several microseconds, and the call is host-bound
    out = list(torch.empty((len(shards),) + shape[:-2]
                           + (h + 2 * hy, w + 2 * hx),
                           dtype=torch.float32, device=dev).unbind(0))
    dst = (ctypes.c_void_p * len(out))(*(o.data_ptr() for o in out))
    top, bot = (None if e is None else e.data_ptr() for e in edges)
    with torch.cuda.device(dev):
        err = _build.load().sbz_halo_exchange_range(
            src, dst, mesh.py, mesh.px, c, h, w, *args, top, bot,
            shards.start, shards.stop,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "halo_exchange_cuda")
    halo_exchange_cuda.launches += 1
    return out


halo_exchange_cuda.launches = 0
