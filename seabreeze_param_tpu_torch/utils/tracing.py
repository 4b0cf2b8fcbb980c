"""Per-routine tracing, the DrHook equivalent; counterpart of
``seabreeze_param_tpu.utils.tracing``.

The reference's UM variant wraps every routine in DrHook enter/exit calls
with ``Module:Routine`` labels (``UM/vn10.7/sea_breeze_diag.F90:64-65,
140-142,172,324``).  Here that has two halves:

  * **device side** — ``torch.profiler.record_function`` ranges (the
    counterpart of ``jax.named_scope``), always on, so a trace taken with
    :func:`profile_trace` shows the same named call tree;
  * **host side** — wall-clock enter/exit timings per label, only when the
    tracer is enabled (DrHook's ``lhook`` guard, ``UM/...F90:172``).  The
    card runs asynchronously, so these time the host's enqueueing unless
    the traced block synchronises.

Also here: :func:`device_info`, the counterpart of the reference's
``get_threads`` (``sobel.f90:195-206``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class _Record:
    calls: int = 0
    total_s: float = 0.0
    child_s: float = 0.0

    @property
    def self_s(self):
        return self.total_s - self.child_s


@dataclass
class Tracer:
    """DrHook-style named enter/exit tracer.

    >>> tracer = Tracer(enabled=True)
    >>> with tracer.hook("pipeline:distance"):
    ...     ...
    >>> tracer.report()   # per-label calls / total / self time
    """

    enabled: bool = False
    records: dict = field(default_factory=lambda: defaultdict(_Record))
    _stack: threading.local = field(default_factory=threading.local)

    @contextlib.contextmanager
    def hook(self, label: str):
        """Named range: profiler annotation, plus host timing when
        enabled."""
        if not self.enabled:
            with torch.profiler.record_function(label):
                yield
            return
        stack = getattr(self._stack, "frames", None)
        if stack is None:
            stack = self._stack.frames = []
        t0 = time.perf_counter()
        stack.append(label)
        try:
            with torch.profiler.record_function(label):
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            rec = self.records[label]
            rec.calls += 1
            rec.total_s += dt
            if stack:
                self.records[stack[-1]].child_s += dt

    def report(self) -> str:
        """DrHook-style profile table, most expensive self-time first."""
        rows = sorted(self.records.items(), key=lambda kv: -kv[1].self_s)
        width = max([len(k) for k, _ in rows] + [7])
        lines = [f"{'routine':<{width}}  {'calls':>6} {'total_s':>9} "
                 f"{'self_s':>9}"]
        for label, rec in rows:
            lines.append(f"{label:<{width}}  {rec.calls:>6} "
                         f"{rec.total_s:>9.4f} {rec.self_s:>9.4f}")
        return "\n".join(lines)

    def reset(self):
        self.records.clear()


#: process-global default tracer (disabled: profiler ranges only)
tracer = Tracer()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile a block with ``torch.profiler`` (the card too, where there is
    one) and write a Chrome trace to ``logdir/trace.json``.  Yields the
    profiler, whose ``key_averages()`` sums the time by op and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_info() -> dict:
    """Parallel-width introspection (the ``get_threads`` analogue,
    sobel.f90:195-206): the card count and kind, or the CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return {"platform": "gpu", "num_devices": n, "num_local_devices": n,
                "num_hosts": 1, "device_kind": torch.cuda.get_device_name(0)}
    return {"platform": "cpu", "num_devices": 1, "num_local_devices": 1,
            "num_hosts": 1, "device_kind": "cpu"}
