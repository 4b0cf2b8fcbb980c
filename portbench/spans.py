"""Helpers of the readers of the port's own spans and counters.

The port names each layer boundary of its paths with a span
(``seabreeze_param_tpu_torch.utils.tracing``): ``layer:phase`` (``api:``,
``pipeline:``, ``trigger:``, ``coupling:``), and ``wait:<site>`` where the
host waits for the device.  A span is a ``torch.profiler.record_function``
range, opened only while a profiler session is active, so a traced run's
window (:class:`trace.Window`) holds them among its host events, on one
time base with the device's.  The counters (``h2d_bytes``) count in the
same session, so after a traced run, whose one profiler session is the
window, they hold the window's counts.

A reader returns None where it finds nothing to read: a window that traced
no device event, no such span, or a counter that is absent or 0 (a
program without the span or counter reads nothing rather than 0).
"""
from __future__ import annotations

import sys

#: The prefixes of the port's span names.
PROGRAM = ("api:", "pipeline:", "trigger:", "coupling:", "wait:")
WAIT = "wait:"
TRACING_MODULE = "seabreeze_param_tpu_torch.utils.tracing"


def window(run):
    """The run's traced window, or None where it traced no device event."""
    win = run.window
    if (win is None or not getattr(win, "trace", False) or not win.device
            or not win.span or not run.steps):
        return None
    return win


def spans(win, keep):
    """``(name, start_us, end_us)`` of the window's host events whose name
    ``keep`` accepts, clipped to the window."""
    lo, hi = win.span
    return [(n, max(s, lo), min(e, hi)) for n, s, e in win.host if keep(n)]


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        elif e > s:
            out.append([s, e])
    return out


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ms_per_step(run, name):
    """Host milliseconds a step inside the spans named ``name``, or None."""
    win = window(run)
    if win is None:
        return None
    found = spans(win, lambda n: n == name)
    if not found:
        return None
    return sum(e - s for _, s, e in found) / 1e3 / run.steps


def waits_per_step(run):
    """``wait:*`` spans that start in the window, a step, or None."""
    win = window(run)
    if win is None:
        return None
    lo, hi = win.span
    n = sum(1 for name, s, _ in win.host
            if name.startswith(WAIT) and lo <= s < hi)
    return n / run.steps if n else None


def program_idle_share(run):
    """The share (%) of the window in which a span of the port is open on
    the host and no event runs on the device, or None."""
    win = window(run)
    if win is None:
        return None
    prog = merged((s, e) for _, s, e in spans(
        win, lambda n: n.startswith(PROGRAM)))
    if not prog:
        return None
    lo, hi = win.span
    dev = merged((max(s, lo), min(e, hi)) for _, s, e in win.device)
    inside = sum(e - s for s, e in prog)
    return 100.0 * (inside - overlap(prog, dev)) / (hi - lo)


def counter_per_step(run, name, scale=1.0):
    """The port's counter ``name`` over the window, over ``scale``, a step,
    or None where the port keeps no such counter or it reads 0.  Reads the
    process-global tracer of a port already loaded; imports nothing."""
    if window(run) is None:
        return None
    tracing = sys.modules.get(TRACING_MODULE)
    counters = getattr(getattr(tracing, "tracer", None), "counters", None)
    value = counters.get(name) if counters else None
    if not value:
        return None
    return value / scale / run.steps
