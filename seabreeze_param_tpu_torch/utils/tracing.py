"""Per-routine tracing, the DrHook equivalent; counterpart of
``seabreeze_param_tpu.utils.tracing``.

The reference's UM variant wraps every routine in DrHook enter/exit calls
with ``Module:Routine`` labels (``UM/vn10.7/sea_breeze_diag.F90:64-65,
140-142,172,324``).  Here one switch serves two readers:

  * **a profiler** — while a ``torch.profiler`` session is active, each
    :meth:`Tracer.hook` opens a ``torch.profiler.record_function`` range
    (the counterpart of ``jax.named_scope``), on the profiler's time base
    with the device's events, so each idle gap of the card lands inside a
    named span;
  * **an operator** — an enabled :class:`Tracer` (DrHook's ``lhook``
    guard, ``UM/...F90:172``) also times each label: the host's time (on
    the card that is the enqueueing) and, where CUDA is available, the
    device's time between a pair of CUDA events recorded on the current
    stream, resolved by :meth:`Tracer.report` with its one synchronise.

With neither, a hook is one shared no-op context and a count does nothing:
the port's spans cost a flag check when nobody reads them.

Labels are ``layer:phase`` (``api:probe``, ``pipeline:step``,
``trigger:ring``, ``coupling:seabreeze_diag``); ``wait:<site>`` marks a
statement at which the host waits for the device (a read-back, or the
upload of a pageable host array between launches).  :meth:`Tracer.count`
adds to a named counter (``h2d_bytes``: the bytes of host arrays the port
takes onto its device; ``staged_bytes``: the float32 bytes ``api.diag``
moves through its staging slots, both ways (``staging.Stager``);
``probe_frame_cells``: the cells of each frame the ring-radius probe's
passes walk, under the span ``probe:transform``) under the same switch.

Also here: :func:`device_info`, the counterpart of the reference's
``get_threads`` (``sobel.f90:195-206``).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

#: The context every hook returns while nobody reads the spans.
_OFF = contextlib.nullcontext()
#: Unresolved CUDA event pairs an enabled tracer holds before it resolves
#: the finished ones (without waiting) to bound its memory.
_PENDING_MAX = 4096


@dataclass
class _Record:
    calls: int = 0
    total_s: float = 0.0
    child_s: float = 0.0
    device_s: float = 0.0
    device_child_s: float = 0.0

    @property
    def self_s(self):
        return self.total_s - self.child_s

    @property
    def device_self_s(self):
        return self.device_s - self.device_child_s


@dataclass
class Tracer:
    """DrHook-style named enter/exit tracer.

    >>> tracer = Tracer(enabled=True)
    >>> with tracer.hook("pipeline:distance"):
    ...     ...
    >>> tracer.count("h2d_bytes", 4096)
    >>> print(tracer.report())  # per label: calls, host and device times
    """

    enabled: bool = False
    records: dict = field(default_factory=lambda: defaultdict(_Record))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    _stack: threading.local = field(default_factory=threading.local)
    _pending: list = field(default_factory=list)

    def hook(self, label: str):
        """Named range: a profiler range while a profiler session is
        active or the tracer is enabled, with host and device timing when
        enabled; else the shared no-op context."""
        if self.enabled:
            return self._timed(label)
        if _autograd_profiler._is_profiler_enabled:
            return torch.profiler.record_function(label)
        return _OFF

    def span(self, label: str):
        """Decorator: the whole call of the function under :meth:`hook`."""
        def wrap(fn):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with self.hook(label):
                    return fn(*args, **kwargs)
            return spanned
        return wrap

    def count(self, name: str, n: int):
        """Add ``n`` to counter ``name``, under the switch of :meth:`hook`."""
        if self.enabled or _autograd_profiler._is_profiler_enabled:
            self.counters[name] += int(n)

    @contextlib.contextmanager
    def _timed(self, label: str):
        stack = getattr(self._stack, "frames", None)
        if stack is None:
            stack = self._stack.frames = []
        parent = stack[-1] if stack else None
        start = None
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
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
            if parent is not None:
                self.records[parent].child_s += dt
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._pending.append((label, parent, start, end))
                if len(self._pending) > _PENDING_MAX:
                    self._resolve(wait=False)

    def _resolve(self, wait: bool):
        """Add the device time of each pending event pair to its label
        (and to its parent's children).  ``wait``: synchronise first;
        else resolve only the leading pairs whose end has been reached."""
        if wait and self._pending:
            torch.cuda.synchronize()
        done = 0
        for label, parent, start, end in self._pending:
            if not wait and not end.query():
                break
            dt = start.elapsed_time(end) / 1e3
            self.records[label].device_s += dt
            if parent is not None:
                self.records[parent].device_child_s += dt
            done += 1
        del self._pending[:done]

    def report(self) -> str:
        """DrHook-style profile table, most expensive self-time first:
        calls, host total and self seconds, and, where CUDA event pairs
        were recorded, device total and self milliseconds; then the
        counters.  Resolves the pending event pairs (one synchronise)."""
        self._resolve(wait=True)
        device = any(rec.device_s for rec in self.records.values())
        rows = sorted(self.records.items(), key=lambda kv: -kv[1].self_s)
        width = max([len(k) for k, _ in rows] + [7])
        head = (f"{'routine':<{width}}  {'calls':>6} {'total_s':>9} "
                f"{'self_s':>9}")
        lines = [head + (f" {'device_ms':>10} {'dev_self_ms':>11}"
                         if device else "")]
        for label, rec in rows:
            line = (f"{label:<{width}}  {rec.calls:>6} "
                    f"{rec.total_s:>9.4f} {rec.self_s:>9.4f}")
            if device:
                line += (f" {rec.device_s * 1e3:>10.3f} "
                         f"{rec.device_self_s * 1e3:>11.3f}")
            lines.append(line)
        if self.counters:
            cw = max([len(k) for k in self.counters] + [7])
            lines.append(f"{'counter':<{cw}}  {'value':>14}")
            lines += [f"{name:<{cw}}  {value:>14d}"
                      for name, value in sorted(self.counters.items())]
        return "\n".join(lines)

    def reset(self):
        self._pending.clear()
        self.records.clear()
        self.counters.clear()


#: process-global default tracer: disabled, so its spans and counters run
#: only inside a profiler session
tracer = Tracer()


def device_info() -> dict:
    """Parallel-width introspection (the ``get_threads`` analogue,
    sobel.f90:195-206): the card count and kind, or the CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return {"platform": "gpu", "num_devices": n, "num_local_devices": n,
                "num_hosts": 1, "device_kind": torch.cuda.get_device_name(0)}
    return {"platform": "cpu", "num_devices": 1, "num_local_devices": 1,
            "num_hosts": 1, "device_kind": "cpu"}
