"""The comparison that decides ``correct``: the program's answers against
the plain reference's, field by field.  Each answer gives four numbers:

* ``sb_off_share``: the share of the coastal entries of ``sb_con`` (those
  that either side gives a value, not the missing value) that disagree.
  Off the coastal band both sides are missing almost everywhere, so a share
  of the whole grid would dilute a fault confined to the band.
* ``sb_max_gap``: the widest gap between the two where both are values, so
  that a fault in a few coastal entries shows however few they are.
* ``sb_missing_flips``: the coastal entries that one side gives the
  missing value and the other not.  Which cells lie within maxdist of the
  coast depends on the grid and the sea ice alone, never on the seed, so
  this comparison is exact: one entry on the wrong side fails it.
* ``state_off_share``: the share of the state's entries that disagree.

An entry of ``sb_con`` disagrees where one side is the missing value and
the other is not (the cell's distance to the coast fell on the other side
of maxdist), or where both are values more than ``SB_ATOL + SB_RTOL *
|reference|`` apart.  The reference takes the ring window's means exactly,
where the program sums them in float32 in its own order; that moves the
heating contrast by up to ~1e-2 K in the widest windows, and the trigger's
value (at most ~11, falling to 0 at each of its thresholds) by less than
the tolerance.  Its discontinuities (the wind speed and direction changes)
are computed from the same float32 winds on both sides.

An entry of the state (t0, windspeed, winddir) disagrees where the two
are more than ``STATE_TOL`` apart (winddir: the angle between them).
"""
from __future__ import annotations

import numpy as np
import torch

MISSING_HALF = 1.0e20
SB_ATOL, SB_RTOL = 1.0e-2, 1.0e-2
STATE_TOL = {"t0": 1.0e-3, "windspeed": 1.0e-4, "winddir": 1.0e-3}


def _dev(a, like):
    return torch.as_tensor(a).to(device=like.device, dtype=torch.float32)


def sb_disagree(got, ref):
    """Bool tensor: the entries of ``sb_con`` that disagree."""
    got = _dev(got, ref)
    ref = ref.to(torch.float32)
    gm, rm = got.abs() > MISSING_HALF, ref.abs() > MISSING_HALF
    off = (got - ref).abs() > SB_ATOL + SB_RTOL * ref.abs()
    return (gm != rm) | (off & ~gm & ~rm)


def sb_numbers(got, ref):
    """``(sb_off_share, sb_max_gap, sb_missing_flips)`` of one answer's
    ``sb_con``."""
    got = _dev(got, ref)
    ref = ref.to(torch.float32)
    gm, rm = got.abs() > MISSING_HALF, ref.abs() > MISSING_HALF
    coastal = ~(gm & rm)
    both = ~gm & ~rm
    off = sb_disagree(got, ref)[coastal]
    d = (got - ref).abs()[both]
    return (share(off), float(d.max()) if d.numel() else 0.0,
            int((gm != rm).sum()))


def state_disagree(got: dict, ref: dict):
    """Bool tensor over the state fields' entries that disagree."""
    parts = []
    for key, tol in STATE_TOL.items():
        if key not in ref:
            continue
        r = ref[key].to(torch.float32)
        d = _dev(got[key], r) - r
        if key == "winddir":
            d = torch.remainder(d + 180.0, 360.0) - 180.0
        parts.append((d.abs() > tol).reshape(-1))
    return torch.cat(parts)


def share(mask) -> float:
    return float(mask.double().mean()) if mask.numel() else 0.0


class Judge:
    """Judges answers against the reference's: the worst of each number
    over every answer judged, and the answers with a number over its
    limit (``limits``: the cell's, number -> limit)."""

    NAMES = ("sb_off_share", "sb_max_gap", "sb_missing_flips",
             "state_off_share")

    def __init__(self, limits: dict):
        self.limits = {k: float(limits[k]) for k in self.NAMES}
        self.worst = dict.fromkeys(self.NAMES, 0.0)
        self.judged = self.failed = 0

    def judge(self, sb, sb_ref, state: dict, state_ref: dict):
        off, gap, flips = sb_numbers(sb, sb_ref)
        got = {"sb_off_share": off, "sb_max_gap": gap,
               "sb_missing_flips": flips,
               "state_off_share": share(state_disagree(state, state_ref))}
        for k, v in got.items():
            self.worst[k] = max(self.worst[k], v)
        self.judged += 1
        self.failed += any(v > self.limits[k] for k, v in got.items())

    def compared(self):
        """Number -> (worst value, limit), the Outcome's ``compared``."""
        return {k: (self.worst[k], self.limits[k]) for k in self.NAMES}


class Reservoir:
    """A sample of ``keep`` of the window's answers, drawn from the seed
    (reservoir sampling), so that a check holds and compares a fixed
    number however many answers the window completes."""

    def __init__(self, keep: int, seed: int):
        self.keep = keep
        self.rng = np.random.default_rng(seed)
        self.items = {}                  # answer index -> what to check
        self.seen = 0

    def offer(self, index, take):
        """Answer ``index`` is done; ``take()`` gives what to keep of it."""
        self.seen += 1
        slot = (self.seen - 1 if self.seen <= self.keep
                else int(self.rng.integers(self.seen)))
        if slot < self.keep:
            if len(self.items) == self.keep:
                self.items.pop(sorted(self.items)[slot])
            self.items[index] = take()
