"""The shard mesh of the 2-D (lat, lon) domain decomposition; counterpart of
``seabreeze_param_tpu.parallel.mesh``.

The JAX package lays a ``('y', 'x')`` mesh over devices, one shard per
device.  Here one process drives every shard: a :class:`ShardMesh` is the
mesh shape ``(py, px)`` and its ``devices``, one entry per *group* of
shards, and a field is a list of ``py * px`` contiguous ``(..., h, w)``
tensors in row-major shard order (shard ``s`` sits at mesh row ``s // px``,
column ``s % px``; lat rows ride y, lon columns ride x).  The groups split
the shard list into equal contiguous runs, and shard ``s`` lives on
``device_of(s)``.  One group is every shard on one device; a mesh over
``n`` cards has ``n`` groups, one card each, as the JAX package's mesh has
one shard per chip; a list that names one card several times gives several
groups on that card, which run the same cross-group code (a launch per
group on the group's own stream, events between the groups) as groups on
separate cards.  :func:`split` cuts a global tensor into that list, each
shard on its device, and :func:`gather` puts it back on ``device``, the
first group's.

On CUDA every group of a mesh of several groups has a stream of its own
(:func:`group_streams`): a group's work is queued on it inside
:func:`on_group`, :func:`fork` orders the groups' streams after the work
queued so far on the cards' current streams, and :func:`join` orders the
current streams after the groups' work.  A one-group mesh uses the caller's
current stream and none of this.

In a multi-process run (``parallel.distributed``) each of ``world``
processes holds a :class:`ShardMesh` of its own: ``py`` contiguous rows of
a global ``(py * world, px)`` mesh at full longitude, starting at global
mesh row ``rank * py``, over that process's devices, split into groups as
above (one group on one card, or several, as the JAX package's multi-host
mesh holds several devices a process); the shard list, :func:`split` and
:func:`gather` then cover that process's row block.  Rank order, then
shard order within a block, is the global mesh's row-major shard order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``py`` lat shards by ``px`` lon shards over ``devices``, one entry
    per group of ``size / groups`` contiguous shards (default: one group,
    every shard on ``device``): the whole mesh, or with ``world`` > 1
    process ``rank``'s rows of a global mesh of ``py * world`` rows.
    ``device`` is the first group's device, where gathers land."""

    py: int
    px: int
    device: torch.device
    rank: int = 0
    world: int = 1
    devices: tuple = ()

    def __post_init__(self):
        devices = tuple(_resolve(d) for d in self.devices or
                        (self.device,))
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "device", devices[0])
        if self.size % len(devices):
            raise ValueError(f"{self.size} shards do not split into "
                             f"{len(devices)} equal groups")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh over {[str(d) for d in devices]} "
                             f"mixes device types")

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

    @property
    def groups(self) -> int:
        return len(self.devices)

    def coords(self, s: int) -> tuple[int, int]:
        """(mesh row, mesh column) of shard ``s``."""
        return divmod(s, self.px)

    def group_of(self, s: int) -> int:
        return s // (self.size // self.groups)

    def device_of(self, s: int) -> torch.device:
        return self.devices[self.group_of(s)]

    def group_shards(self, g: int) -> range:
        """The shards of group ``g``, a contiguous run."""
        n = self.size // self.groups
        return range(g * n, (g + 1) * n)


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _one_device(device):
    """The single device of ``device`` (None: the current card, and an
    error where there is none; a CPU mesh is only built when asked for)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device for the default "
                               "mesh; pass device='cpu' for a CPU mesh")
        device = "cuda"
    return _resolve(device)


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


def _near_square(n: int) -> tuple[int, int]:
    """The JAX package's automatic shape: the near-square factorisation of
    ``n``, biased toward more lon shards."""
    py = int(np.floor(np.sqrt(n)))
    while n % py:
        py -= 1
    return py, n // py


def make_mesh(shape=None, device=None) -> ShardMesh:
    """Build a mesh, by the JAX package's ``make_mesh(shape, devices)``.

    ``device`` — None: every visible card, as ``jax.devices()`` (without a
    card this raises; a CPU mesh is built only when asked for); a list:
    one group per entry (entries that name one card several times give
    several groups there); one device: every shard on it, one group.
    ``shape`` — ``None``/``'auto'``: the near-square factorisation of the
    list's length, biased toward more lon shards, one shard per entry (for
    one device, of the visible card count: 1 x 1 on one card or none);
    ``'PYxPX'`` or ``(py, px)``: ``S = py * px`` shards.  Over ``n``
    entries, ``S % n == 0`` puts ``S / n`` contiguous row-major shards on
    each; ``S < n`` warns, as JAX does, and uses the first ``S`` entries;
    anything else raises.  A list that mixes device types is refused.
    """
    dims = parse_shape(shape)
    if device is not None and not isinstance(device, (list, tuple)):
        device = _one_device(device)
        if dims is None:
            dims = _near_square(max(1, torch.cuda.device_count()))
        return ShardMesh(dims[0], dims[1], device)
    if device is None:
        _one_device(None)
        device = [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in device]
    if not devices:
        raise ValueError("make_mesh: an empty device list")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"make_mesh: {[str(d) for d in devices]} mixes "
                         f"device types")
    n = len(devices)
    dims = dims or _near_square(n)
    want = dims[0] * dims[1]
    if want < n:
        warnings.warn(f"mesh shape {dims} uses only {want} of {n} "
                      f"available devices")
        devices = devices[:want]
    elif want % n:
        raise ValueError(f"mesh shape {dims}: {want} shards do not split "
                         f"evenly over {n} devices")
    return ShardMesh(dims[0], dims[1], devices[0], devices=tuple(devices))


def split(field, mesh: ShardMesh):
    """(..., py*h, px*w) tensor -> list of the mesh's (..., h, w) shards in
    row-major order, each a contiguous copy (never aliasing ``field``) on
    its group's device."""
    nlat, nlon = field.shape[-2], field.shape[-1]
    if nlat % mesh.py or nlon % mesh.px:
        raise ValueError(f"field {nlat}x{nlon} does not divide into a "
                         f"{mesh.py}x{mesh.px} mesh")
    h, w = nlat // mesh.py, nlon // mesh.px
    out = []
    for s in range(mesh.size):
        iy, ix = mesh.coords(s)
        x = field[..., iy * h:(iy + 1) * h, ix * w:(ix + 1) * w]
        dev = mesh.device_of(s)
        out.append(x.clone(memory_format=torch.contiguous_format)
                   if x.device == dev else x.to(dev).contiguous())
    return out


def gather(shards, mesh: ShardMesh):
    """Inverse of :func:`split`: one (..., py*h, px*w) tensor on
    ``mesh.device``."""
    shards = [x.to(mesh.device) for x in shards]
    rows = [torch.cat(shards[iy * mesh.px:(iy + 1) * mesh.px], dim=-1)
            for iy in range(mesh.py)]
    return torch.cat(rows, dim=-2)


_STREAMS: dict = {}


def group_streams(mesh: ShardMesh) -> list:
    """One CUDA stream per group of a mesh of several groups on cards (kept
    per card and group index, so every call gets the same ones); None per
    group of a one-group mesh (the caller's current stream) or a CPU
    mesh."""
    if mesh.groups == 1 or mesh.device.type != "cuda":
        return [None] * mesh.groups
    out = []
    for g, dev in enumerate(mesh.devices):
        if (dev.index, g) not in _STREAMS:
            _STREAMS[dev.index, g] = torch.cuda.Stream(dev)
        out.append(_STREAMS[dev.index, g])
    return out


@contextlib.contextmanager
def on_group(mesh: ShardMesh, g: int):
    """Queue the body's work on group ``g``'s device and stream (nothing
    changes for a one-group or CPU mesh)."""
    stream = group_streams(mesh)[g]
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def fork(mesh: ShardMesh):
    """Order each group's stream after the work queued so far on its
    card's current stream."""
    for stream in group_streams(mesh):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(stream.device))


def join(mesh: ShardMesh):
    """Order each card's current stream after the work queued so far on
    its groups' streams."""
    for stream in group_streams(mesh):
        if stream is not None:
            torch.cuda.current_stream(stream.device).wait_stream(stream)


@functools.cache
def source_groups(mesh: ShardMesh, g: int) -> tuple[int, ...]:
    """The groups whose shards an exchange into group ``g``'s shards reads
    (``g`` included): each shard's eight neighbours, lon ringed, lat
    clamped (a halo is never wider than a shard)."""
    out = set()
    for s in mesh.group_shards(g):
        iy, ix = mesh.coords(s)
        for y in range(max(iy - 1, 0), min(iy + 2, mesh.py)):
            for dx in (-1, 0, 1):
                out.add(mesh.group_of(y * mesh.px + (ix + dx) % mesh.px))
    return tuple(sorted(out))
