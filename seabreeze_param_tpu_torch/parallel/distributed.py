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
would not put two ranks on one GPU, and a rank's device is
``cuda:{LOCAL_RANK % device_count}``: on a one-card machine every rank
shares it.

Usage (``torchrun --nproc_per_node 2 ...`` sets the variables; without
them everything below is the single-process run)::

    from seabreeze_param_tpu_torch.parallel import distributed as dist
    dist.initialize()                  # no-op unless WORLD_SIZE > 1
    mesh = dist.make_multihost_mesh()  # (world, 1), mesh rows by process
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
from .mesh import ShardMesh, _one_device, parse_shape
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


def make_multihost_mesh(shape=None, device=None) -> ShardMesh:
    """This process's block of a global ``(py, px)`` mesh: ``py / world``
    contiguous mesh rows at full longitude, on ``device`` (default: the
    current card), one card per process: the block is one group
    (``parallel.mesh``), where JAX's multi-host meshes may hold several
    devices a process.  ``shape`` — ``None``/``'auto'``: ``(world, 1)``,
    the JAX package's rule with one device per process; ``'PYxPX'`` or a
    tuple.  The lat axis must split evenly over the processes."""
    world = world_size()
    dims = parse_shape(shape) or (world, 1)
    if dims[0] % world:
        # DistributedRunner feeds each process a contiguous row block
        raise ValueError(f"mesh shape {dims} cannot split y={dims[0]} "
                         f"contiguously over {world} processes")
    return ShardMesh(dims[0] // world, dims[1], _one_device(device), rank(),
                     world)


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


def exchange_edges(local, mesh: ShardMesh, hy: int):
    """Trade boundary rows with the neighbouring processes for a halo of
    ``hy`` rows: this block's first ``hy`` rows go to rank - 1 and its last
    ``hy`` rows to rank + 1, each at full width (the mesh row's shards side
    by side).  Returns ``(top, bot)`` on the shards' device: the rows of
    rank - 1 that lie above this block and those of rank + 1 below it,
    ``(..., hy, px*w)``, None at a global edge (or for hy = 0)."""
    if mesh.world == 1 or hy == 0:
        return None, None
    px, h = mesh.px, local[0].shape[-2]
    last = (mesh.py - 1) * px
    sends, recvs = {}, {}
    if mesh.rank > 0:
        sends[mesh.rank - 1] = torch.cat(
            [local[ix][..., :hy, :] for ix in range(px)], dim=-1)
    if mesh.rank < mesh.world - 1:
        sends[mesh.rank + 1] = torch.cat(
            [local[last + ix][..., h - hy:, :] for ix in range(px)], dim=-1)
    reqs = []
    for peer, rows in sends.items():
        host = _host(rows)
        recvs[peer] = _host_empty(host.shape, rows)
        reqs.append((host, dist.isend(host, peer)))
        reqs.append((recvs[peer], dist.irecv(recvs[peer], peer)))
    for _, req in reqs:
        req.wait()
    dev = local[0].device
    return tuple(None if peer not in recvs
                 else recvs[peer].to(dev, non_blocking=True)
                 for peer in (mesh.rank - 1, mesh.rank + 1))


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
