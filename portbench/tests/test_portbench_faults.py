"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of the work left out, an
answer altered where it is produced (one coastal entry of each answer
turned into the missing value), and the coupling run at its default
ring bound, which falls short of the rings that sea ice needs.  The harness's look for a card is
skipped (the run is on the CPU); the rest of a run is driven as it is."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import helpers

from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.coupling import CoupledTrigger


def diag_fault(kind):
    def diag(tt, lsm, z, std, lon, lat, pres, u, v, theta, ci, *, ws=None,
             wd=None, thc=None, **kw):
        if kind == "half_left_out":
            T = theta.shape[0]
            half = slice(0, (T + 1) // 2)
            out = api.diag(tt, lsm, z, std, lon, lat, pres, u[half],
                           v[half], theta[half],
                           None if ci is None else ci[half], ws=ws, wd=wd,
                           thc=thc, **kw)
            sb = np.concatenate([out[1], out[1]])[:T]
            return (tt + T, sb) + tuple(out[2:])
        out = list(api.diag(tt, lsm, z, std, lon, lat, pres, u, v, theta,
                            ci, ws=ws, wd=wd, thc=thc, **kw))
        if kind == "state_unchanged":
            zeros = np.zeros(np.shape(lsm), np.float32)
            out[2:] = [zeros if a is None else a for a in (thc, ws, wd)]
        elif kind == "answer_altered":
            out[1] = out[1].copy()
            flat = out[1].reshape(-1)
            flat[np.flatnonzero(np.abs(flat) < 1e20)[0]] = MISSING
        return tuple(out)
    return diag


class CoupledFault:
    def __init__(self, ctx, kind):
        from portbench import world
        lon, lat = world.grid(ctx.config["grid"])
        self.port = CoupledTrigger(grid=Grid(lon=lon, lat=lat),
                                   params=Params(**ctx.config["params"]),
                                   device="cpu")
        self.kind = kind

    def prepare_mask(self, lsm, ice):
        return self.port.prepare_mask(lsm, ice)

    def physics(self, state, *args):
        new, out = self.port.physics(state, *args)
        sb = out["sb_con"]
        if self.kind == "state_unchanged":
            new = state
        elif self.kind == "half_left_out":
            out["sb_con"] = torch.cat([sb[:sb.shape[0] // 2],
                                       torch.zeros_like(sb[sb.shape[0] // 2:])])
        elif self.kind == "answer_altered":
            flat = sb.clone().reshape(-1)
            flat[torch.nonzero(flat.abs() < 1e20)[0, 0]] = MISSING
            out["sb_con"] = flat.reshape(sb.shape)
        return new, out


KINDS = ["state_unchanged", "half_left_out", "answer_altered"]
MISSING = 2.0e20


@pytest.mark.parametrize("kind", KINDS)
def test_diag_fault_is_caught(kind):
    result, _ = helpers.run("era5_025.diag_ice", system=diag_fault(kind))
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_coupled_fault_is_caught(kind):
    ctx = helpers.context("ral_1p5km.coupled")
    ctx.system = CoupledFault(ctx, kind)
    from portbench import harness
    result, _ = harness.run_cell(ctx)
    assert result["correct"] is False and result["failed"] > 0


def test_coupled_default_ring_bound_is_caught():
    """``CoupledTrigger``'s default bound, k + 2 + margin = 9 here, with
    the ice edge: on a grid twice the tiny one's width, 147 of the 2731
    coastal cells' rings reach past it, to 17 (as on the cell's own grid,
    where the cell pins the bound for that reason)."""
    from portbench import harness
    wide = dict(helpers.TINY_GRID, nlon=128, lon1=32.0)
    result, _ = harness.run_cell(helpers.context(
        "ral_1p5km.coupled", grid=wide, coupled_nn_max=None))
    assert result["correct"] is False and result["failed"] > 0
