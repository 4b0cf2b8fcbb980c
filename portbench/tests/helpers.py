"""Shared set-up of the benchmark's CPU tests: every cell run at a tiny
size on the CPU, through the port's plain path."""
from __future__ import annotations

import time

from portbench import harness

#: A 40 x 64 regional grid 0.25 deg apart from 60 N (k = 5).
TINY_GRID = {"nlat": 40, "nlon": 64, "lat0": 60.0, "lat1": 60.0 - 39 * 0.25,
             "lon0": 0.0, "lon1": 16.0}
CELLS = ("era5_025.diag_ice", "ral_1p5km.coupled")


def tiny(cell):
    """Overrides that cut ``cell`` to the tiny grid: diag calls of 12
    steps (two wind refreshes at 60 min), 8 levels for the coupled step's
    3-D pressure, 4 checked steps and an ice update every 5 steps."""
    if cell.endswith("coupled"):
        return {"grid": TINY_GRID, "nlev": 8, "check_samples": 4,
                "ice_period_steps": 5, "warmup_steps": 3}
    return {"grid": TINY_GRID, "steps_per_call": 12}


def context(cell, seed=2**31 + 11, seconds=0.3, trace=False, system=None,
            **overrides):
    """The tiny ``cell``'s context; ``overrides`` update its keys further."""
    return harness.context(cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), system=system,
                           overrides={**tiny(cell), **overrides})


def run(cell, **kw):
    """``(result, lines)`` of one tiny run of ``cell`` on the CPU."""
    return harness.run_cell(context(cell, **kw))
