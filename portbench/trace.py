"""The measured window, and with ``--trace 1`` the profiler's reading of it.

The window is timed by the host's clock.  Traced, it also runs under
``torch.profiler`` (CPU and CUDA activities), inside a range named
``portbench.window``; the device's events (kernels, copies, fills) and the
host's ops are read back from the profiler's kineto events, on one time
base, and clipped to that range.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

WINDOW_RANGE = "portbench.window"


def busy(intervals):
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Window:
    """Context manager around the measured window.  ``wall_s``: its length
    by the host's clock.  Traced (``trace=True``): ``device`` and ``host``,
    lists of ``(name, start_us, end_us)`` inside the window, and ``span``,
    the window's ``(start_us, end_us)`` on the profiler's time base."""

    def __init__(self, trace: bool, cuda: bool):
        self.trace = trace
        self.cuda = cuda
        self.device, self.host, self.span = [], [], None
        self._prof = self._range = None

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW_RANGE)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self._t0
        if self.trace:
            self._range.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType
        events = self._prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            start = e.start_ns() / 1e3
            item = (e.name(), start, start + e.duration_ns() / 1e3)
            if e.device_type() == DeviceType.CUDA:
                # the host's ranges drawn on the device's timeline are no
                # device work
                if not e.is_user_annotation():
                    dev.append(item)
            elif e.name() == WINDOW_RANGE:
                self.span = item[1:]
            else:
                host.append(item)
        if self.span is None:
            raise RuntimeError("the profiler lost the window's range")
        lo, hi = self.span
        self.device = [d for d in dev if d[2] > lo and d[1] < hi]
        self.host = [h for h in host if h[2] > lo and h[1] < hi]
        self._prof = None

    def elapsed(self):
        """Seconds since the window opened, by the host's clock."""
        return time.perf_counter() - self._t0

    @property
    def window_s(self):
        return (self.span[1] - self.span[0]) / 1e6

    def busy_s(self):
        lo, hi = self.span
        return busy((max(s, lo), min(e, hi)) for _, s, e in self.device) / 1e6

    def breakdown(self, top=10):
        """``{"device_ops": [[name, s], ...], "idle_gaps": [[what, s],
        ...]}``: the device operations that took most time, and the idle
        gaps summed by what the host was doing in each: the innermost host
        op open at the gap's middle, and in the benchmark's own ranges also
        the last op the host finished before it."""
        ops = defaultdict(float)
        for name, s, e in self.device:
            ops[name] += (e - s) / 1e6
        gaps = defaultdict(float)
        lo, hi = self.span
        host = sorted(self.host, key=lambda h: h[1])
        stack, done, i, end = [], ("", lo, lo), 0, lo
        for _, s, e in sorted(self.device, key=lambda d: d[1]) + [
                ("", hi, hi)]:
            s = min(s, hi)
            if s > end:
                mid = (s + end) / 2
                while i < len(host) and host[i][1] <= mid:
                    stack.append(host[i])
                    i += 1
                # pop what closed before the middle; the stack holds the
                # open ops, innermost last, where the host's ops nest
                keep = []
                for h in stack:
                    if h[2] < mid:
                        if h[2] > done[2]:
                            done = h
                    else:
                        keep.append(h)
                stack = keep
                if not stack:
                    what = "no host op"
                else:
                    what = stack[-1][0]
                    if what.startswith("portbench.") and done[0]:
                        what += " after " + done[0]
                gaps[what] += (s - end) / 1e6
            end = max(end, e)
        pick = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in pick],
                "idle_gaps": [[n[:160], v] for n, v in idle]}
