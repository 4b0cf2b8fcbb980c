"""Multi-process execution over ``torch.distributed``; counterpart of
``seabreeze_param_tpu.parallel.distributed``.

The reference runs its decomposed UM run across nodes with MPI
``swap_bounds`` (``UM/vn10.7/sea_breeze_diag.F90:408-410``; SURVEY §5.8).
Here, as in the JAX package, one process per host (or per card) joins a
process group, a global ``(py, px)`` mesh is split by mesh rows over the
processes, and each process runs its block with the same
:class:`parallel.sharded.ShardedPipeline`.  What crosses processes:

* the halo rows at a process edge (``parallel.halo`` trades ``hy`` rows at
  full width with the neighbour, :func:`exchange_edges`);
* the sigmoid's global statistics (:func:`all_gather_cat` of each shard's
  partials, reduced in global shard order);
* in ``api.diag`` and :meth:`ShardedPipeline.run`, the outputs, gathered
  back to the global grid on every process (:func:`gather_rows`).

The process group uses the ``gloo`` backend, so every tensor it carries is
staged through host memory (pinned where it comes from a card).  NCCL
would not put two ranks on one GPU, and a rank's default device is
``cuda:{LOCAL_RANK % device_count}``: on a one-card machine every rank
shares it.  A rank may hold several devices, as a JAX process holds
several: :func:`make_multihost_mesh` then lays its block over a device
list, one group of shards per entry (``parallel.mesh``), and a process
edge's rows are sent from, and delivered to, the cards of the groups
that hold the block's edge rows.

Usage (``torchrun --nproc_per_node 2 ...`` sets the variables; without
them everything below is the single-process run)::

    from seabreeze_param_tpu_torch.parallel import distributed as dist
    dist.initialize()                  # no-op unless WORLD_SIZE > 1
    mesh = dist.make_multihost_mesh()  # (world, 1), mesh rows by process
    # or each rank's block over two cards, global mesh (world, 2):
    # mesh = dist.make_multihost_mesh(device=["cuda:0", "cuda:1"])
    runner = dist.DistributedRunner(ShardedPipeline(pipe, mesh))
    final, outs = runner.run(state_local, theta_local, ..., lsm_local, ...)
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import TriggerState
from .mesh import (ShardMesh, _near_square, _one_device, _resolve, fork,
                   join, parse_shape)
from .sharded import OUT_KEYS, ShardedPipeline, take_rows


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK % device_count}``."""
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method: str | None = None,
               world: int | None = None, rank_: int | None = None) -> None:
    """Join the process group (backend ``gloo``) from ``torchrun``'s
    variables: ``MASTER_ADDR`` (default localhost), ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  A no-op when
    ``WORLD_SIZE`` is unset or 1, or the group already exists.  On a
    machine with cards, the current device becomes :func:`local_device`,
    so the entry points' default ``'cuda'`` names it."""
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1")) if world is None else world
    if world <= 1 or dist.is_initialized():
        return
    missing = [v for v, given in (("RANK", rank_), ("MASTER_PORT",
                                                     init_method))
               if given is None and v not in env]
    if missing:
        # each process would otherwise run the whole series alone
        raise RuntimeError(f"WORLD_SIZE={world} without {', '.join(missing)}"
                           f": launch with torchrun, or set MASTER_ADDR, "
                           f"MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK")
    rank_ = int(env["RANK"]) if rank_ is None else rank_
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env['MASTER_PORT']}")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank_)


def barrier() -> None:
    """Wait for every process (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


def multihost_shape(world: int, per: int, shape=None) -> tuple[int, int]:
    """The global mesh shape of ``world`` processes of ``per`` devices each,
    by the JAX package's ``make_multihost_mesh``: ``None``/``'auto'`` is
    ``(world * py, per // py)``, ``(py, per // py)`` the near-square
    factorisation of ``per``; ``'PYxPX'`` or a tuple as given.  The lat
    axis must split evenly over the processes, and each process's block of
    ``(y / world) * x`` shards evenly over its ``per`` devices."""
    dims = parse_shape(shape)
    if dims is None:
        py, px = _near_square(per)
        dims = (world * py, px)
    if dims[0] % world:
        # DistributedRunner feeds each process a contiguous row block
        raise ValueError(f"mesh shape {dims} cannot split y={dims[0]} "
                         f"contiguously over {world} processes")
    block = dims[0] // world * dims[1]
    if block % per:
        raise ValueError(f"mesh shape {dims}: {block} shards do not split "
                         f"evenly over {per} devices")
    return dims


def make_multihost_mesh(shape=None, device=None) -> ShardMesh:
    """This process's block of a global ``(py, px)`` mesh: ``py / world``
    contiguous mesh rows at full longitude.  ``device`` — None: the current
    card (:func:`local_device` after :func:`initialize`), one group; one
    device: one group there; a list: one group of shards per entry, as
    ``make_mesh(shape, device=[...])`` (an entry named several times gives
    several groups on one card), as the JAX package's multi-host mesh
    holds several devices a process.  ``shape`` — ``None``/``'auto'``:
    :func:`multihost_shape`'s default, ``(world, 1)`` for one device;
    ``'PYxPX'`` or a tuple."""
    world = world_size()
    if isinstance(device, (list, tuple)):
        devices = [_resolve(d) for d in device]
        if not devices:
            raise ValueError("make_multihost_mesh: an empty device list")
    else:
        devices = [_one_device(device)]
    dims = multihost_shape(world, len(devices), shape)
    return ShardMesh(dims[0] // world, dims[1], devices[0], rank(), world,
                     devices=tuple(devices))


def _host(t):
    """``t`` in host memory, for gloo: a pinned copy of a card's tensor."""
    if t.device.type == "cpu":
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _host_empty(shape, like):
    return torch.empty(shape, dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def all_gather_cat(t):
    """``t`` (the same shape on every process) concatenated along dim 0 in
    rank order, on ``t``'s device."""
    if world_size() == 1:
        return t
    h = _host(t)
    parts = [torch.empty_like(h) for _ in range(world_size())]
    dist.all_gather(parts, h)
    return torch.cat(parts).to(t.device)


def gather_rows(local, rows: int, nlat: int):
    """The global ``(..., nlat, nlon)`` field on every process from each
    process's row block ``local`` (``(..., r, nlon)``, r <= ``rows``; the
    blocks follow each other in rank order, each ``rows`` long once padded
    here)."""
    x = local
    if x.shape[-2] < rows:
        pad = list(x.shape)
        pad[-2] = rows - x.shape[-2]
        x = torch.cat([x, x.new_zeros(pad)], dim=-2)
    g = all_gather_cat(x.movedim(-2, 0).contiguous())
    return g[:nlat].movedim(0, -2).contiguous()


def _host_rows(local, mesh: ShardMesh, iy: int, rows: slice):
    """Rows ``rows`` of mesh row ``iy`` at full width, ``(..., r, px*w)``,
    in one host buffer (pinned where the shards lie on cards), assembled
    group by group: each group's run of the row's shards joined on its own
    device and copied into the buffer's columns."""
    px = mesh.px
    first = local[iy * px][..., rows, :]
    w = first.shape[-1]
    buf = _host_empty(first.shape[:-1] + (px * w,), first)
    for g in range(mesh.groups):
        run = mesh.group_shards(g)
        lo, hi = max(run.start, iy * px), min(run.stop, (iy + 1) * px)
        if lo < hi:
            buf[..., (lo - iy * px) * w:(hi - iy * px) * w].copy_(torch.cat(
                [local[s][..., rows, :] for s in range(lo, hi)], dim=-1))
    return buf


def _row_devices(mesh: ShardMesh, iy: int) -> list:
    """The devices of the groups that hold a shard of mesh row ``iy``, each
    once, in group order."""
    return list(dict.fromkeys(mesh.device_of(iy * mesh.px + ix)
                              for ix in range(mesh.px)))


def exchange_edges(local, mesh: ShardMesh, hy: int) -> dict:
    """Trade boundary rows with the neighbouring processes for a halo of
    ``hy`` rows: this block's first ``hy`` rows go to rank - 1 and its last
    ``hy`` rows to rank + 1, each at full width (the mesh row's shards side
    by side, each read on its own device).  Returns ``{device: (top,
    bot)}``: the rows of rank - 1 that lie above this block, delivered to
    every card whose groups hold a shard of the block's first mesh row,
    and those of rank + 1 below it, to every card holding a shard of its
    last, ``(..., hy, px*w)`` (a group reads the whole strip: its corners
    take the columns beside its own); None at a global edge, and ``{}``
    with one process or hy = 0.

    On cards the shards may have been written on their groups' streams
    (``parallel.mesh.on_group``): the reads wait on them (``join``), and
    the groups' streams wait on the delivering copies (``fork``)."""
    if mesh.world == 1 or hy == 0:
        return {}
    h = local[0].shape[-2]
    join(mesh)
    sends, recvs = {}, {}
    if mesh.rank > 0:
        sends[mesh.rank - 1] = _host_rows(local, mesh, 0, slice(0, hy))
    if mesh.rank < mesh.world - 1:
        sends[mesh.rank + 1] = _host_rows(local, mesh, mesh.py - 1,
                                          slice(h - hy, h))
    reqs = []
    for peer, host in sends.items():
        recvs[peer] = _host_empty(host.shape, local[0])
        reqs.append(dist.isend(host, peer))
        reqs.append(dist.irecv(recvs[peer], peer))
    for req in reqs:
        req.wait()
    edges = {}
    for side, (peer, iy) in enumerate(((mesh.rank - 1, 0),
                                       (mesh.rank + 1, mesh.py - 1))):
        if peer in recvs:
            for dev in _row_devices(mesh, iy):
                edges.setdefault(dev, [None, None])[side] = recvs[peer].to(
                    dev, non_blocking=True)
    fork(mesh)
    return {dev: tuple(pair) for dev, pair in edges.items()}


@dataclasses.dataclass
class DistributedRunner:
    """Per-process feeding of a :class:`ShardedPipeline` over a
    :func:`make_multihost_mesh` block: each process passes only the global
    rows ``[row_lo, row_hi)`` it owns (the last process's block may stop at
    the real grid's last row) and gets back that block's outputs.  With one
    process this is :meth:`ShardedPipeline.run`."""

    sp: ShardedPipeline

    def __post_init__(self):
        self.nlat_pad = self.sp.nlat_pad
        self.row_lo, self.row_hi = self.sp.row_lo, self.sp.row_hi

    def pad_rows_local(self, arr):
        """The lat replication padding (rows along dim -2), on the last
        process's block only (the padding rows lie at the global bottom):
        a float32 tensor on the mesh's device there, ``arr`` elsewhere."""
        if self.row_hi == self.nlat_pad != self.sp.nlat_real:
            rows = np.minimum(np.arange(self.row_hi - self.row_lo),
                              np.shape(arr)[-2] - 1)
            return take_rows(arr, rows, self.sp.mesh.device)
        return arr

    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None):
        """:meth:`ShardedPipeline.run` with every field argument this
        process's row block (``pres`` 1-D, or its block of a 3-D field);
        returns ``(final_state, outputs)`` of the block's real rows,
        tensors on the mesh's device."""
        pad = self.pad_rows_local
        pres_b = pad(pres) if np.ndim(pres) == 3 else pres
        final, outs = self.sp.run_block(
            TriggerState(state.tt, pad(state.thc), pad(state.windspeed),
                         pad(state.winddir)),
            pad(theta_t), pad(u_t), pad(v_t), pad(lsm), pad(z), pad(std),
            pres_b, ci_t=None if ci_t is None else pad(ci_t))
        real = min(self.row_hi, self.sp.nlat_real) - self.row_lo
        return (TriggerState(final.tt, final.thc[:real],
                             final.windspeed[:real], final.winddir[:real]),
                {key: outs[key][:, :real] for key in OUT_KEYS})
