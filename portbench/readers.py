"""Helpers of the per-layer metric readers (``metrics/<name>.py``).

A reader takes a path's :class:`harness.Outcome` and returns its number,
or None where the traced window holds nothing for it to read (no trace, no
device events, no kernel of its names), so that the metric is left out
of the result line rather than read as 0.
"""
from __future__ import annotations

import re

from portbench import roofline

#: Name prefixes of the profiler's device events that are copies and fills.
COPY_PREFIX = "Memcpy"
FILL_PREFIX = "Memset"
#: Every kernel of the port's ``csrc/``; the device's other kernels are
#: PyTorch's own.
CSRC = re.compile(r"\b(ring_kernel|land_rows|land_cols|sweep_latch|"
                  r"sweep_catchup|sweep_bands|sweep_final|"
                  r"min_haversine_kernel|pieces_kernel|pass1_rows_kernel|"
                  r"pass2_min_kernel|pass2_pruned_kernel|two_row_extrema|"
                  r"two_bound|halo_rows)\b")


def events(run):
    """The traced window's device events, or None untraced / empty."""
    win = run.window
    if win is None or not getattr(win, "trace", False) or not win.device:
        return None
    return win.device


def per_step_ms(run, keep):
    """Device milliseconds a step of the events whose name ``keep``
    accepts, or None where there are none."""
    evs = events(run)
    if evs is None or not run.steps:
        return None
    picked = [(e - s) for name, s, e in evs if keep(name)]
    if not picked:
        return None
    return sum(picked) / 1e3 / run.steps


def roofline_share(run, work_key, pattern):
    """The share (%) of the least time the card needs for the window's
    ``run.work[work_key]`` in the device time of the kernels whose names
    ``pattern`` finds, or None."""
    evs = events(run)
    if evs is None or work_key not in run.work:
        return None
    rx = re.compile(pattern)
    dev_us = sum(e - s for name, s, e in evs if rx.search(name))
    if dev_us <= 0:
        return None
    least_s, _ = roofline.bound(*run.work[work_key])
    return 100.0 * least_s / (dev_us / 1e6)


def launches_per_step(run):
    evs = events(run)
    if evs is None or not run.steps:
        return None
    return len(evs) / run.steps


def idle_share(run):
    evs = events(run)
    if evs is None:
        return None
    return 100.0 * (1.0 - run.window.busy_s() / run.window.window_s)
