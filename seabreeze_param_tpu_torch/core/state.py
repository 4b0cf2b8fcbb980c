"""Persistent trigger state as a dataclass of tensors.

Counterpart of ``seabreeze_param_tpu.core.state``.  The reference threads
``(thc, windspeed, winddir)`` plus the timestep counter ``tt`` through every
call; here ``tt`` is a plain Python int (it only steers host-side branches:
first-step seeding and the wind-refresh cadence) and the three fields are
float32 tensors on the pipeline's device.

Reference quirk, preserved: the threaded ``thc`` slot carries the sea-level
temperature t0 of the last step, not the thermal heating contrast (see the
JAX package's ``core/state.py`` docstring).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TriggerState:
    """State threaded between timesteps.

    tt  : int — timestep counter, 1-based like the reference.
    thc : (nlat, nlon) f32 — last step's sea-level temperature t0.
    windspeed, winddir : (nlat, nlon) f32 — wind at the target level,
          refreshed every ``target_time`` hours on coastal cells.
    """

    tt: int
    thc: torch.Tensor
    windspeed: torch.Tensor
    winddir: torch.Tensor

    @staticmethod
    def zeros(shape: tuple[int, int], device, tt: int = 1) -> "TriggerState":
        """Cold-start state: zeros, tt=1 unless given.  Three distinct
        buffers, because the kernel path updates the wind fields in
        place."""
        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return TriggerState(tt=int(tt), thc=z(), windspeed=z(), winddir=z())

    @property
    def shape(self):
        return tuple(self.thc.shape)

    def to_numpy(self):
        """``(tt, thc, windspeed, winddir)`` as an int and host float32
        arrays — the form the JAX package's state converts to and from."""
        return (self.tt,) + tuple(
            a.detach().cpu().numpy() for a in (self.thc, self.windspeed,
                                               self.winddir))


def state_from_numpy(tt, thc, ws, wd, device) -> TriggerState:
    """Build a state on ``device`` from host arrays (e.g. the JAX package's
    state as numpy), copying so the caller's arrays are never aliased."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return TriggerState(tt=int(tt), thc=t(thc), windspeed=t(ws),
                        winddir=t(wd))
