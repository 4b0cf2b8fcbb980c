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

* ``'kernel'`` — kernel B6 (``ops/cuda/halo_kernel.py``): ONE launch for
  every shard and channel, with the lat fills and seam patches folded in,
  so the padded blocks are complete when ``halo_start`` returns (its CPU
  tensors take the plain version below);
* ``'plain'`` — B6's plain version: ``halo_start`` slices each shard's
  eight neighbour strips and corners (:func:`halo_parts`), ``halo_finish``
  joins them with ``torch.cat`` and applies the fills and patches.

The fill options are given to ``halo_start`` (the JAX package gives them
to ``halo_finish``), because B6 applies them in its one launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .mesh import ShardMesh

LAT_FILLS = ("clamp", "zero")
BACKENDS = ("kernel", "plain")


def halo_parts(local, mesh: ShardMesh, hy: int, hx: int):
    """Per shard, the dict of its received strips and corners (keys
    ``left right top bot tl tr bl br``; ``None`` where the bounded lat axis
    has no neighbour).  Corners come straight from the diagonal neighbour.
    """
    py, px = mesh.shape

    def at(iy, ix):
        return local[iy * px + ix % px] if 0 <= iy < py else None

    def cut(t, rows, cols):
        return None if t is None else t[..., rows, cols]

    h, w = local[0].shape[-2:]
    top_r, bot_r = slice(h - hy, h), slice(0, hy)
    left_c, right_c, all_c = slice(w - hx, w), slice(0, hx), slice(0, w)
    parts = []
    for s in range(mesh.size):
        iy, ix = mesh.coords(s)
        p = {}
        if hx:
            p["left"] = cut(at(iy, ix - 1), slice(0, h), left_c)
            p["right"] = cut(at(iy, ix + 1), slice(0, h), right_c)
        if hy:
            p["top"] = cut(at(iy - 1, ix), top_r, all_c)
            p["bot"] = cut(at(iy + 1, ix), bot_r, all_c)
        if hy and hx:
            p["tl"] = cut(at(iy - 1, ix - 1), top_r, left_c)
            p["tr"] = cut(at(iy - 1, ix + 1), top_r, right_c)
            p["bl"] = cut(at(iy + 1, ix - 1), bot_r, left_c)
            p["br"] = cut(at(iy + 1, ix + 1), bot_r, right_c)
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
    out = list(blocks)
    for s, b in enumerate(blocks):
        _, ix = mesh.coords(s)
        if ix == 0 or ix == mesh.px - 1:
            b = b.clone()
            if ix == 0:
                b[..., :, hx - 1] = b[..., :, hx]
            if ix == mesh.px - 1:
                b[..., :, hx + w - 1] = b[..., :, hx + w]
            out[s] = b
    return out


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
                        lat_fill: str = "clamp", exact_lon: bool = True):
    """Kernel B6's plain version: the padded (..., h+2hy, w+2hx) block of
    every shard, from :func:`halo_parts` and ``torch.cat``."""
    check_exchange(local, mesh, hy, hx, lat_fill)
    return _assemble(local, halo_parts(local, mesh, hy, hx), mesh, hy, hx,
                     lat_fill, exact_lon)


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
    shape ``(..., h, w)``).  ``'kernel'``: one launch of B6 (the plain
    version for CPU tensors) writes the finished padded blocks; ``'plain'``:
    the neighbour strips are sliced, to be joined by :func:`halo_finish`."""
    backend = resolve_backend(backend)
    check_exchange(local, mesh, hy, hx, lat_fill)
    if backend == "kernel":
        from ..ops.cuda.halo_kernel import halo_exchange_cuda
        padded = halo_exchange_cuda(local, mesh, hy, hx, lat_fill=lat_fill,
                                    exact_lon=exact_lon)
        return HaloParts(local, mesh, hy, hx, lat_fill, exact_lon,
                         padded=padded)
    return HaloParts(local, mesh, hy, hx, lat_fill, exact_lon,
                     parts=halo_parts(local, mesh, hy, hx))


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
