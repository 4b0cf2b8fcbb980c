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

The sharded forms (``save_state_sharded``/``restore_state_sharded``) belong
to the multi-process run, which the port does not have yet; with one
process, the port's ``ShardedPipeline`` returns the gathered state, which
:func:`save_state` takes.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from .state import TriggerState

_FILE = "state.pt"


def _dir(directory) -> str:
    return os.path.abspath(os.path.expanduser(str(directory)))


def _steps(directory: str) -> list[int]:
    """Completed steps in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(directory, n, _FILE)))


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
    its ``tt`` step, synchronously.  Returns the step number."""
    directory = _dir(directory)
    step = int(state.tt)
    steps = _steps(directory)
    if steps and steps[-1] >= step:
        return step
    payload = {"state": {"tt": step}}
    for name in ("thc", "windspeed", "winddir"):
        payload["state"][name] = _tensor(getattr(state, name)).float()
    if extra:
        payload["extra"] = {k: _tensor(v) for k, v in extra.items()}
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{_FILE}.", dir=step_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(step_dir, _FILE))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in (steps + [step])[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
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


def latest_step(directory: str):
    """The resume point, or None when the directory has no checkpoints."""
    steps = _steps(_dir(directory))
    return steps[-1] if steps else None
