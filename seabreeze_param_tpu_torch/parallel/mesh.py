"""The shard mesh of the 2-D (lat, lon) domain decomposition; counterpart of
``seabreeze_param_tpu.parallel.mesh``.

The JAX package lays a ``('y', 'x')`` mesh over devices, one shard per
device.  Here one process runs every shard: a :class:`ShardMesh` is the
mesh shape ``(py, px)`` and the one device all of its shards live on, and a
field is a list of ``py * px`` contiguous ``(..., h, w)`` tensors in
row-major shard order (shard ``s`` sits at mesh row ``s // px``, column
``s % px``; lat rows ride y, lon columns ride x).  :func:`split` cuts a
global tensor into that list and :func:`gather` puts it back.

In a multi-process run (``parallel.distributed``) each of ``world``
processes holds a :class:`ShardMesh` of its own: ``py`` contiguous rows of
a global ``(py * world, px)`` mesh at full longitude, starting at global
mesh row ``rank * py``; the shard list, :func:`split` and :func:`gather`
then cover that process's row block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``py`` lat shards by ``px`` lon shards, all on ``device``: the whole
    mesh, or with ``world`` > 1 process ``rank``'s rows of a global mesh of
    ``py * world`` rows."""

    py: int
    px: int
    device: torch.device
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.py, self.px)

    @property
    def global_shape(self) -> tuple[int, int]:
        return (self.py * self.world, self.px)

    @property
    def row0(self) -> int:
        """The global mesh row of this process's first mesh row."""
        return self.rank * self.py

    @property
    def size(self) -> int:
        return self.py * self.px

    def coords(self, s: int) -> tuple[int, int]:
        """(mesh row, mesh column) of shard ``s``."""
        return divmod(s, self.px)


def _one_device(device):
    """The single device of ``device`` (None: the current card, and an
    error where there is none; a CPU mesh is only built when asked for); a
    set of several devices is refused."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device for the default "
                               "mesh; pass device='cpu' for a CPU mesh")
        device = "cuda"
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        if len(devs) != 1:
            raise NotImplementedError(
                "a mesh over several devices is not ported yet (ROADMAP.md "
                "queue 1, item 5: one mesh across several cards)")
        device = devs.pop()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def parse_shape(shape) -> tuple[int, int] | None:
    """``None``/``'auto'`` -> None; ``'2x4'`` or ``(2, 4)`` -> (2, 4)."""
    if shape is None or shape == "auto":
        return None
    if isinstance(shape, str):
        shape = shape.lower().split("x")
    py, px = (int(n) for n in shape)
    if py < 1 or px < 1:
        raise ValueError(f"mesh shape {(py, px)}: both axes must be >= 1")
    return py, px


def make_mesh(shape=None, device=None) -> ShardMesh:
    """Build a mesh on one device.

    ``shape`` — ``None``/``'auto'``: the near-square factorisation of the
    visible card count biased toward more lon shards (the JAX package's
    rule; 1 x 1 on one card or none); ``'PYxPX'`` or ``(py, px)``: that
    many shards on ``device``.  ``device`` — one device (default: the
    current card; without one this raises); a list naming several is
    refused.
    """
    device = _one_device(device)
    dims = parse_shape(shape)
    if dims is None:
        n = max(1, torch.cuda.device_count())
        py = int(np.floor(np.sqrt(n)))
        while n % py:
            py -= 1
        dims = (py, n // py)
    return ShardMesh(dims[0], dims[1], device)


def split(field, mesh: ShardMesh):
    """(..., py*h, px*w) tensor -> list of the mesh's (..., h, w) shards in
    row-major order, each a contiguous copy (never aliasing ``field``)."""
    nlat, nlon = field.shape[-2], field.shape[-1]
    if nlat % mesh.py or nlon % mesh.px:
        raise ValueError(f"field {nlat}x{nlon} does not divide into a "
                         f"{mesh.py}x{mesh.px} mesh")
    h, w = nlat // mesh.py, nlon // mesh.px
    return [field[..., iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].clone(
        memory_format=torch.contiguous_format)
        for iy in range(mesh.py) for ix in range(mesh.px)]


def gather(shards, mesh: ShardMesh):
    """Inverse of :func:`split`: one (..., py*h, px*w) tensor."""
    rows = [torch.cat(shards[iy * mesh.px:(iy + 1) * mesh.px], dim=-1)
            for iy in range(mesh.py)]
    return torch.cat(rows, dim=-2)
