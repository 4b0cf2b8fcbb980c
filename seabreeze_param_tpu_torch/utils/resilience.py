"""Failure detection + elastic recovery for long batch runs; a copy of
``seabreeze_param_tpu.utils.resilience`` on top of the port's
:mod:`..core.checkpoint` (``torch.save`` in place of orbax).

The reference has essentially no failure handling — an integer ``error``
out-arg in the UM variant (``UM/vn10.7/sea_breeze_diag.F90:102,196-202``)
and print-and-continue config errors (``configdir.py:278-280``); a
preempted multi-month run loses everything (SURVEY §5.3).  This module is
the standard production answer scaled to this framework:

* :class:`Watchdog` — a liveness monitor: the run beats once per work unit;
  a missing beat past the deadline marks the run stalled (the single-host
  analogue of multi-host coordinator heartbeats) and invokes a callback.
  The bare class defaults to logging; ``run_resilient`` installs an ACTING
  callback that aborts the stalled unit (async :class:`StallError` in the
  runner thread) and re-enters it through the restore/retry machinery.
  A stall inside one blocked C call (a truly hung device dispatch) cannot
  be interrupted in-process — there the checkpoint directory is the
  recovery: a supervising restart resumes after the last completed unit.
* :func:`run_resilient` — unit-at-a-time driver loop with periodic
  checkpoints (``core.checkpoint``) and restart-from-last-checkpoint
  retries: on an exception the state (and the index of the next unit) is
  restored from disk and the loop resumes, skipping completed units —
  elastic recovery for preemption/OOM/transient-backend failures.

The unit of work is deliberately the driver's outer loop step (one dated
input file, ``test_run.py:18``), not a model timestep: checkpoint cost is
amortized over a whole file's scan and the recovery cut points match the
reference's own state-threading boundaries.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterable, Sequence

from ..core import checkpoint as ckpt
from ..core.state import TriggerState

logger = logging.getLogger("seabreeze_param_tpu_torch.resilience")


class StallError(Exception):
    """Raised (asynchronously) in the runner thread when the watchdog
    deadline passes with no progress beat; handled by ``run_resilient``'s
    restore-and-retry machinery like any other unit failure."""


def _async_raise(thread_ident: int, exc_type) -> bool:
    """Schedule ``exc_type`` in the thread with ``thread_ident``.

    Uses ``PyThreadState_SetAsyncExc``: the exception surfaces the next
    time that thread executes Python bytecode.  That aborts stalls in
    Python-level loops, host IO waits, and the gaps *between* device
    dispatches — but cannot interrupt a single blocked C call (a truly
    hung device call needs process-level supervision; the checkpoint
    directory makes the restarted process resume, which is the designed
    recovery for that case).
    """
    import ctypes
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    return res == 1


class Watchdog:
    """Liveness monitor: call :meth:`beat` at least every ``deadline_s``.

    A background thread checks the last-beat timestamp; when the deadline
    passes it fires ``on_stall(seconds_since_beat)`` once per stall episode
    (re-armed by the next beat).  Use as a context manager.
    """

    def __init__(self, deadline_s: float = 600.0,
                 on_stall: Callable[[float], None] | None = None,
                 poll_s: float | None = None):
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall or self._default_on_stall
        self._poll_s = poll_s if poll_s is not None else min(
            5.0, self.deadline_s / 4)
        self._last = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread = None
        self.stall_count = 0

    @staticmethod
    def _default_on_stall(age_s: float):
        logger.error("watchdog: no progress for %.1f s", age_s)

    def beat(self):
        self._last = time.monotonic()
        self._stalled = False

    def _run(self):
        while not self._stop.wait(self._poll_s):
            age = time.monotonic() - self._last
            if age > self.deadline_s and not self._stalled:
                self._stalled = True
                self.stall_count += 1
                try:
                    self.on_stall(age)
                except Exception:   # the monitor must never kill the run
                    logger.exception("watchdog on_stall callback failed")

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sbz-watchdog")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def run_resilient(units: Sequence, step_fn: Callable,
                  state: TriggerState, ckpt_dir: str, *,
                  save_every: int = 1, max_retries: int = 2,
                  retry_wait_s: float = 0.0,
                  watchdog_deadline_s: float | None = None,
                  progress: Callable[[int, object], None] | None = None):
    """Run ``state = step_fn(state, unit)`` over ``units`` with recovery.

    Checkpoints ``state`` plus the next unit index to ``ckpt_dir`` every
    ``save_every`` completed units.  On entry, resumes from the latest
    checkpoint in ``ckpt_dir`` (skipping completed units) — so a *new
    process* pointed at the same directory continues the series, exactly
    like re-entering the reference's ``diag`` with the saved (tt, thc, ws,
    wd) triple, but automatic.  On an exception mid-unit, restores the last
    checkpoint and retries that unit up to ``max_retries`` times.

    Returns ``(state, completed_units)``.
    """
    units = list(units)
    start = 0
    saved, extra = ckpt.restore_state(ckpt_dir)
    if saved is not None:
        state = saved
        start = int(extra.get("next_unit", 0)) if extra else 0
        logger.info("resuming from checkpoint: tt=%s, unit %d/%d",
                    int(saved.tt), start, len(units))

    completed = start
    retries = 0
    runner_tid = threading.get_ident()

    def _abort_stalled(age_s: float):
        # The acting watchdog: abort the stalled unit by raising StallError
        # in the runner thread; the except path below restores the last
        # checkpoint and retries the unit (up to max_retries), exactly like
        # any other transient failure.  See _async_raise for the limits.
        logger.error("watchdog: no progress for %.1f s — aborting the "
                     "current unit and retrying from the last checkpoint",
                     age_s)
        _async_raise(runner_tid, StallError)

    wd_ctx = (Watchdog(watchdog_deadline_s, on_stall=_abort_stalled)
              if watchdog_deadline_s else None)

    def _save(i):
        ckpt.save_state(ckpt_dir, state, extra={"next_unit": i})

    if start == 0:
        _save(0)   # the fresh-start anchor the first retry restores to

    try:
        if wd_ctx:
            wd_ctx.__enter__()
        i = start
        while i < len(units):
            # The try covers the full loop body so a watchdog StallError
            # landing between the step and the checkpoint save still takes
            # the restore-and-retry path instead of escaping.
            try:
                state = step_fn(state, units[i])
                i += 1
                completed = i
                if wd_ctx:
                    wd_ctx.beat()
                if progress:
                    progress(i - 1, units[i - 1])
                if save_every and (i % save_every == 0 or i == len(units)):
                    _save(i)
            except Exception:
                retries += 1
                if retries > max_retries:
                    _save(i)   # leave a resume point for the next process
                    raise
                logger.exception(
                    "unit %d failed (retry %d/%d); restoring last "
                    "checkpoint", i, retries, max_retries)
                if wd_ctx:
                    wd_ctx.beat()   # re-arm: the retry is fresh progress
                if retry_wait_s:
                    time.sleep(retry_wait_s)
                restored, extra = ckpt.restore_state(ckpt_dir)
                if restored is not None:
                    state = restored
                    i = int(extra.get("next_unit", i)) if extra else i
                continue
    finally:
        if wd_ctx:
            wd_ctx.__exit__(None, None, None)
    return state, completed
