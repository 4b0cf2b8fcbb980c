"""Checkpoint / resume of the persistent trigger state; counterpart of
``seabreeze_param_tpu.core.checkpoint``, with ``torch.save`` in place of
orbax.

The reference's checkpointing story is manual state threading: the driver
carries ``(tt, thc, windspeed, winddir)`` across monthly files
(``test_run.py:39-49``) and a rerun must re-enter ``diag`` with the saved
triple.  Here, as in the JAX package, a batch run can resume mid-series
after preemption.

Layout and semantics are orbax's as the JAX package uses them: one step
directory per save, step number = ``tt`` (the global timestep counter), so
``latest_step`` IS the resume point; a save at a step no newer than the
latest is skipped; the newest ``max_to_keep`` steps are kept.  Each step
directory holds ``state.pt``, a dict of CPU tensors and ints written with
``torch.save`` to a temporary name and renamed into place, and read back
with ``torch.load(weights_only=True)``.  The port does not read the JAX
package's orbax checkpoints, nor the JAX package the port's.

In a multi-process run (``parallel.distributed``) :func:`save_state`
takes the global state, which every process holds alike: process 0 writes
it and every process waits for the write, so each can restore it.
:func:`save_state_sharded` instead writes each process's row block
without gathering it, and :func:`restore_state_sharded` reads back only
the rows a process owns.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from .state import TriggerState

_FILE = "state.pt"
_SHARDS = "shards.pt"   # a sharded step's index, written last


def _dir(directory) -> str:
    return os.path.abspath(os.path.expanduser(str(directory)))


def _steps(directory: str, name: str = _FILE) -> list[int]:
    """Completed steps in ``directory`` (those holding ``name``), oldest
    first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(directory, n, name)))


def _write(payload, path: str):
    """``torch.save`` to a temporary name beside ``path``, then rename."""
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _prune(directory: str, steps: list[int], max_to_keep: int):
    for old in steps[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (array or tensor), in native
    byte order: a tensor cannot hold a big-endian array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    a = np.asarray(a)
    return torch.tensor(a.astype(a.dtype.newbyteorder("=")))


def save_state(directory: str, state: TriggerState, *, extra: dict = None,
               max_to_keep: int = 3) -> int:
    """Save ``state`` (arrays or tensors, and optional extra arrays) under
    its ``tt`` step, synchronously.  Returns the step number.  In a
    multi-process run every process calls it with the same global state;
    process 0 writes and all return once it has."""
    from ..parallel.distributed import barrier, rank
    directory = _dir(directory)
    step = int(state.tt)
    steps = _steps(directory)
    if rank() == 0 and not (steps and steps[-1] >= step):
        payload = {"state": {"tt": step}}
        for name in ("thc", "windspeed", "winddir"):
            payload["state"][name] = _tensor(getattr(state, name)).float()
        if extra:
            payload["extra"] = {k: _tensor(v) for k, v in extra.items()}
        step_dir = os.path.join(directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        _write(payload, os.path.join(step_dir, _FILE))
        _prune(directory, steps + [step], max_to_keep)
    barrier()
    return step


def restore_state(directory: str, step: int | None = None):
    """Restore ``(state, extra)`` from the given (default: latest) step, as
    host float32 arrays and ``tt`` an int; ``extra`` maps names to arrays.

    Returns ``(None, None)`` when no checkpoint exists — callers start the
    run fresh, exactly as the reference driver does (``test_run.py:13-17``).
    """
    directory = _dir(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            return None, None
        step = steps[-1]
    payload = torch.load(os.path.join(directory, str(step), _FILE),
                         weights_only=True)
    s = payload["state"]
    state = TriggerState(tt=int(s["tt"]), thc=s["thc"].numpy(),
                         windspeed=s["windspeed"].numpy(),
                         winddir=s["winddir"].numpy())
    extra = payload.get("extra")
    if extra is not None:
        extra = {k: v.numpy() for k, v in extra.items()}
    return state, extra


def save_state_sharded(directory: str, state: TriggerState, row_lo: int, *,
                       max_to_keep: int = 3) -> int:
    """Save this process's row block of a global state (``state``'s fields
    are the global rows ``[row_lo, row_lo + rows)``) without gathering it:
    each process writes ``rows.{rank}.pt`` (its block and row range) into
    the step directory, and once all have, process 0 writes the step's
    index, which marks the step complete.  Synchronous; returns the step
    number (``tt``, the same on every process)."""
    from ..parallel.distributed import barrier, rank, world_size
    directory = _dir(directory)
    step = int(state.tt)
    steps = _steps(directory, _SHARDS)
    if steps and steps[-1] >= step:
        return step
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    fields = {name: _tensor(getattr(state, name)).float()
              for name in ("thc", "windspeed", "winddir")}
    rows = fields["thc"].shape[-2]
    _write({"rows": (int(row_lo), int(row_lo) + rows), **fields},
           os.path.join(step_dir, f"rows.{rank()}.pt"))
    barrier()
    if rank() == 0:
        _write({"tt": step, "files": world_size()},
               os.path.join(step_dir, _SHARDS))
        _prune(directory, steps + [step], max_to_keep)
    barrier()
    return step


def restore_state_sharded(directory: str, row_lo: int, row_hi: int,
                          step: int | None = None):
    """The global rows ``[row_lo, row_hi)`` of a state saved by
    :func:`save_state_sharded` at ``step`` (default: the latest), read
    from the files that hold them only: a :class:`TriggerState` of host
    float32 arrays and ``tt`` an int.  Returns None when no checkpoint
    exists.  Any process count may restore what any other saved."""
    directory = _dir(directory)
    if step is None:
        steps = _steps(directory, _SHARDS)
        if not steps:
            return None
        step = steps[-1]
    step_dir = os.path.join(directory, str(step))
    index = torch.load(os.path.join(step_dir, _SHARDS), weights_only=True)
    parts = {}
    for r in range(index["files"]):
        path = os.path.join(step_dir, f"rows.{r}.pt")
        block = torch.load(path, weights_only=True, mmap=True)
        lo, hi = block["rows"]
        a, b = max(lo, row_lo), min(hi, row_hi)
        if a < b:
            for name in ("thc", "windspeed", "winddir"):
                parts.setdefault(name, []).append(
                    (a, block[name][..., a - lo:b - lo, :].numpy().copy()))
    fields = {name: np.concatenate([p[1] for p in sorted(
        pieces, key=lambda p: p[0])], axis=-2) for name, pieces in parts.items()}
    if not fields or fields["thc"].shape[-2] != row_hi - row_lo:
        raise ValueError(f"checkpoint step {step}: rows [{row_lo}, {row_hi}) "
                         f"not all saved")
    return TriggerState(tt=int(index["tt"]), **fields)


def latest_step(directory: str):
    """The resume point, or None when the directory has no checkpoints."""
    steps = _steps(_dir(directory))
    return steps[-1] if steps else None
