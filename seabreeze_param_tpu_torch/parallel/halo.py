"""Halo exchange over a mesh's shard list — the ``swap_bounds`` of the
decomposed run; counterpart of ``seabreeze_param_tpu.parallel.halo``.

Longitude is a ring; latitude is bounded, and the global-edge shards fill
their missing halo rows by the reference's boundary rules:

  * ``lat_fill='clamp'`` — copies of the global edge row (the Fortran
    ``min(max(1, i), nlats)`` clamp; Sobel and ring search);
  * ``lat_fill='zero'`` — zeros (distance transform: rows beyond the grid
    are never coastline sources).

The reference's quirky lon map ``max(1, modulo(j, nlons))`` differs from
clean periodicity at exactly two slots after a periodic exchange
(``exact_lon=True``, :func:`quirky_seam_patch`): padded position -1 of the
shard owning column 0 holds column 0, and interior position n-1 of the
shard owning it aliases to column 0.  An axis of size 1 is its own
neighbour when periodic and has none when bounded.

Split phase, as in the JAX package: :func:`halo_start` issues the exchange
and :func:`halo_finish` returns the padded blocks; :func:`halo_pad` is both
at once.  Two backends:

* ``'kernel'`` — kernel B6 (``ops/cuda/halo_kernel.py``): one launch per
  group of the mesh (ONE for a mesh on one device) for all of its shards
  and channels, with the lat fills and seam patches folded in, so the
  padded blocks are complete when ``halo_start`` returns (its CPU tensors
  take the plain version below); over several groups each launch runs on
  its group's device and stream after the groups it reads from
  (``halo_exchange_cuda``);
* ``'plain'`` — B6's plain version: ``halo_start`` slices each shard's
  eight neighbour strips and corners (:func:`halo_parts`, each moved to
  the destination shard's device), ``halo_finish`` joins them with
  ``torch.cat`` and applies the fills and patches, on the current
  streams.

The fill options are given to ``halo_start`` (the JAX package gives them
to ``halo_finish``), because B6 applies them in its one launch.

A process's block of a multi-process mesh (``ShardMesh.world`` > 1) keeps
the fills only at the global edges (the top of rank 0, the bottom of the
last rank).  At a process edge ``halo_start`` first trades boundary rows
with the neighbouring process (``parallel.distributed.exchange_edges``:
``hy`` rows at full width, through host buffers over gloo, delivered to
each card whose groups hold the block's first or last mesh row), and the
rows beyond that edge take the neighbour's rows in place of the fill, on
both backends, each group reading the copy on its own card
(:func:`group_edges`); the lon ring and the seam patches then come out as
on one process.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .mesh import ShardMesh

LAT_FILLS = ("clamp", "zero")
BACKENDS = ("kernel", "plain")


def group_edges(edges, mesh: ShardMesh, g: int):
    """The process-edge strips group ``g``'s shards read, ``(top, bot)``:
    from ``edges`` (``{device: (top, bot)}``, as
    ``parallel.distributed.exchange_edges`` returns; None or ``{}``: no
    process edge) the copies on ``g``'s device, the top where a shard of
    ``g`` lies on the block's first mesh row and the bottom where one lies
    on its last; None at a global edge or where ``g`` has no such shard.
    A strip ``g`` reads that has no copy on its device is refused."""
    edges = edges or {}
    dev = mesh.devices[g]
    shards = mesh.group_shards(g)
    reads = (mesh.coords(shards.start)[0] == 0,
             mesh.coords(shards.stop - 1)[0] == mesh.py - 1)
    mine = edges.get(dev, (None, None))
    out = []
    for side, read in enumerate(reads):
        if read and mine[side] is None and any(
                pair[side] is not None for pair in edges.values()):
            raise ValueError(f"group {g} on {dev} reads the "
                             f"{('top', 'bottom')[side]} process edge, which "
                             f"has no copy on its device")
        out.append(mine[side] if read else None)
    return tuple(out)


def halo_parts(local, mesh: ShardMesh, hy: int, hx: int, edges=None):
    """Per shard, the dict of its received strips and corners (keys
    ``left right top bot tl tr bl br``; ``None`` where the bounded lat axis
    has no neighbour).  Corners come straight from the diagonal neighbour.
    ``edges`` — ``{device: (top, bot)}``: the neighbour process's boundary
    rows ``(..., hy, px*w)`` beyond this block's first or last mesh row,
    which serve as that row's neighbours, each shard taking the copy on
    its group's device (:func:`group_edges`); None at a global edge."""
    py, px = mesh.shape
    h, w = local[0].shape[-2:]
    per_group = [group_edges(edges, mesh, g) for g in range(mesh.groups)]

    def cut(s, iy, ix, rows, cols):
        """Shard ``s``'s part from the shard at (iy, ix), or from the
        process edge beyond the block that its group reads."""
        ix %= px
        if 0 <= iy < py:
            return local[iy * px + ix][..., rows, cols]
        edge = per_group[mesh.group_of(s)][0 if iy < 0 else 1]
        return (None if edge is None
                else edge[..., ix * w:(ix + 1) * w][..., cols])

    top_r, bot_r = slice(h - hy, h), slice(0, hy)
    left_c, right_c, all_c = slice(w - hx, w), slice(0, hx), slice(0, w)
    parts = []
    for s in range(mesh.size):
        iy, ix = mesh.coords(s)
        p = {}
        if hx:
            p["left"] = cut(s, iy, ix - 1, slice(0, h), left_c)
            p["right"] = cut(s, iy, ix + 1, slice(0, h), right_c)
        if hy:
            p["top"] = cut(s, iy - 1, ix, top_r, all_c)
            p["bot"] = cut(s, iy + 1, ix, bot_r, all_c)
        if hy and hx:
            p["tl"] = cut(s, iy - 1, ix - 1, top_r, left_c)
            p["tr"] = cut(s, iy - 1, ix + 1, top_r, right_c)
            p["bl"] = cut(s, iy + 1, ix - 1, bot_r, left_c)
            p["br"] = cut(s, iy + 1, ix + 1, bot_r, right_c)
        if mesh.groups > 1:
            dev = local[s].device
            p = {key: None if t is None else t.to(dev)
                 for key, t in p.items()}
        parts.append(p)
    return parts


def quirky_seam_patch(blocks, mesh: ShardMesh, hx: int, w: int):
    """The reference's quirky-lon seam patches on x-padded blocks
    (``(..., *, w + 2*hx)``, periodic exchange already in place, hx < w):
    in the first mesh column, position -1 := the first interior column
    (global column 0); in the last, interior position n-1 := the right
    halo's first column (global column 0).  Also right for blocks whose
    values were computed on a periodic apron (the slot layout is
    positional).  Returns a new list; patched blocks are copies."""
    return [seam_patch(b, mesh.coords(s)[1], mesh.px, hx, w)
            for s, b in enumerate(blocks)]


def seam_patch(b, ix: int, px: int, hx: int, w: int):
    """:func:`quirky_seam_patch` of one block, in mesh column ``ix`` of
    ``px``: ``b`` itself, or a patched copy in the first or last column."""
    if ix == 0 or ix == px - 1:
        b = b.clone()
        if ix == 0:
            b[..., :, hx - 1] = b[..., :, hx]
        if ix == px - 1:
            b[..., :, hx + w - 1] = b[..., :, hx + w]
    return b


def check_exchange(local, mesh: ShardMesh, hy: int, hx: int, lat_fill):
    """Refuse what no exchange takes: a shard count off the mesh, shards of
    different shapes, a halo wider than the shard, an unknown fill."""
    if len(local) != mesh.size:
        raise ValueError(f"{len(local)} shards for a {mesh.py}x{mesh.px} "
                         f"mesh")
    shape = tuple(local[0].shape)
    if any(tuple(x.shape) != shape for x in local):
        raise ValueError("shards of different shapes")
    h, w = shape[-2:]
    if not (0 <= hy <= h and 0 <= hx <= w):
        raise ValueError(f"halo ({hy}, {hx}) wider than the {h}x{w} shard")
    if lat_fill not in LAT_FILLS:
        raise ValueError(f"lat_fill {lat_fill!r}: want one of {LAT_FILLS}")


def halo_exchange_plain(local, mesh: ShardMesh, hy: int, hx: int, *,
                        lat_fill: str = "clamp", exact_lon: bool = True,
                        edges=None):
    """Kernel B6's plain version: the padded (..., h+2hy, w+2hx) block of
    every shard, from :func:`halo_parts` and ``torch.cat``; ``edges`` as
    in :func:`halo_parts`."""
    check_exchange(local, mesh, hy, hx, lat_fill)
    return _assemble(local, halo_parts(local, mesh, hy, hx, edges), mesh, hy,
                     hx, lat_fill, exact_lon)


def _assemble(local, parts, mesh, hy, hx, lat_fill, exact_lon):
    """Join each shard with its parts, fill the global lat edges, patch the
    seam."""
    out = []
    for x, p in zip(local, parts):
        mid = torch.cat([p["left"], x, p["right"]], dim=-1) if hx else x
        if hy:
            rep = list(mid.shape)
            rep[-2] = hy
            rows = []
            for key, corners, edge in (("top", ("tl", "tr"), slice(0, 1)),
                                       ("bot", ("bl", "br"), slice(-1, None))):
                strip = p[key]
                if strip is None:       # the global lat edge
                    strip = (mid[..., edge, :].expand(rep)
                             if lat_fill == "clamp" else mid.new_zeros(rep))
                elif hx:
                    strip = torch.cat([p[corners[0]], strip, p[corners[1]]],
                                      dim=-1)
                rows.append(strip)
            mid = torch.cat([rows[0], mid, rows[1]], dim=-2)
        out.append(mid)
    if hx and exact_lon:
        out = quirky_seam_patch(out, mesh, hx, local[0].shape[-1])
    return out


class HaloParts(NamedTuple):
    """An exchange in flight, from :func:`halo_start`: the padded blocks
    (B6) or the received strips (plain)."""
    local: list
    mesh: ShardMesh
    hy: int
    hx: int
    lat_fill: str
    exact_lon: bool
    padded: list | None = None
    parts: list | None = None


def resolve_backend(backend: str, use_kernels=None) -> str:
    """``'auto'`` is ``'kernel'`` unless ``use_kernels`` is False."""
    if backend == "auto":
        return "plain" if use_kernels is False else "kernel"
    if backend not in BACKENDS:
        raise ValueError(f"halo backend {backend!r}: want 'auto' or one of "
                         f"{BACKENDS}")
    return backend


def halo_start(local, mesh: ShardMesh, hy: int, hx: int, *,
               lat_fill: str = "clamp", exact_lon: bool = True,
               backend: str = "kernel") -> HaloParts:
    """Issue the exchange of a shard list (``mesh.size`` tensors of one
    shape ``(..., h, w)``, each on its group's device).  ``'kernel'``: one
    launch of B6 per group (the plain version for CPU tensors) writes the
    finished padded blocks; ``'plain'``: the neighbour strips are sliced,
    to be joined by :func:`halo_finish`.
    A process edge's rows are traded with the neighbour first (module
    docstring)."""
    backend = resolve_backend(backend)
    check_exchange(local, mesh, hy, hx, lat_fill)
    edges = None
    if mesh.world > 1:
        from .distributed import exchange_edges
        edges = exchange_edges(local, mesh, hy)
    if backend == "kernel":
        from ..ops.cuda.halo_kernel import halo_exchange_cuda
        padded = halo_exchange_cuda(local, mesh, hy, hx, lat_fill=lat_fill,
                                    exact_lon=exact_lon, edges=edges)
        return HaloParts(local, mesh, hy, hx, lat_fill, exact_lon,
                         padded=padded)
    return HaloParts(local, mesh, hy, hx, lat_fill, exact_lon,
                     parts=halo_parts(local, mesh, hy, hx, edges))


def halo_finish(parts: HaloParts):
    """The padded ``(..., h + 2*hy, w + 2*hx)`` blocks of an exchange."""
    if parts.padded is not None:
        return parts.padded
    return _assemble(parts.local, parts.parts, parts.mesh, parts.hy,
                     parts.hx, parts.lat_fill, parts.exact_lon)


def halo_pad(local, mesh: ShardMesh, hy: int, hx: int, *,
             lat_fill: str = "clamp", exact_lon: bool = True,
             backend: str = "kernel"):
    """One-shot form of :func:`halo_start` + :func:`halo_finish`."""
    return halo_finish(halo_start(local, mesh, hy, hx, lat_fill=lat_fill,
                                  exact_lon=exact_lon, backend=backend))


def swap_bounds(local, mesh: ShardMesh, halo_size: int, **kw):
    """The reference's ``swap_bounds`` contract: the same halo in both
    dims."""
    return halo_pad(local, mesh, halo_size, halo_size, **kw)
