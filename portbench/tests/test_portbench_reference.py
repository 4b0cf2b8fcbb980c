"""The plain reference against the port's plain path at a tiny size, and
the comparison that decides ``correct`` against lower precision."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import compare, world
from portbench.reference import trigger as ref
from portbench.tests import helpers

from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.coastline import get_edges

CPU = torch.device("cpu")


def tiny_world(seed=3, T=12):
    lon, lat = world.grid(helpers.TINY_GRID)
    h, w = len(lat), len(lon)
    g = world.generator(seed, CPU)
    lsm, z, std = world.make_world(h, w, g, CPU)
    return dict(lon=lon, lat=lat, lsm=lsm, z=z, std=std,
                pres=world.pressure_levels(4, 100000.0, 50000.0, CPU),
                theta=world.noise((T, h, w), 5.0, 288.0, g, CPU),
                u=world.noise((T, 4, h, w), 6.0, 0.0, g, CPU),
                v=world.noise((T, 4, h, w), 6.0, 0.0, g, CPU),
                ci=torch.stack([world.ice_field(h, w, 3 + t // 4, CPU)
                                for t in range(T)]))


@pytest.mark.parametrize("edge", [0, 3, 7])
def test_coastline_and_distance_match_the_port(edge):
    f = tiny_world()
    ci = world.ice_field(40, 64, edge, CPU)
    pipe = TriggerPipeline(grid=Grid(lon=f["lon"], lat=f["lat"]), device=CPU)
    assert torch.equal(ref.coastline(f["lsm"], ci), get_edges(f["lsm"], ci))
    cd, reach, k = ref.distance_field(f["lsm"], ci, f["lon"], f["lat"],
                                      ref.Settings())
    assert k == pipe.k
    got = pipe.distance_field(f["lsm"], ci)
    assert torch.equal(got.abs() >= 12000, cd.abs() >= 12000)
    assert torch.allclose(got, cd, rtol=2e-5, atol=2e-3)


def port_diag(f, **params):
    n = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in f.items()}
    return api.diag(1, n["lsm"], n["z"], n["std"], n["lon"], n["lat"],
                    n["pres"], n["u"], n["v"], n["theta"], n["ci"],
                    device=CPU, **params)


def test_diag_matches_the_port():
    f = tiny_world()
    _, sb, thc, ws, wd = port_diag(f, timestep=60.0)
    st = ref.State(1, *(torch.zeros_like(f["lsm"]) for _ in range(3)))
    st, sb_ref, _ = ref.diag(st, f["lsm"], f["z"], f["std"], f["lon"],
                             f["lat"], f["pres"], f["u"], f["v"], f["theta"],
                             f["ci"], ref.Settings(timestep=60.0))
    assert (sb_ref != 0).any() and (sb_ref.abs() < 1e20).any()
    assert compare.share(compare.sb_disagree(sb, sb_ref)) == 0.0
    assert compare.share(compare.state_disagree(
        {"t0": thc, "windspeed": ws, "winddir": wd},
        {"t0": st.thc, "windspeed": st.windspeed,
         "winddir": st.winddir})) == 0.0


def test_inputs_rounded_to_bfloat16_are_judged_incorrect():
    """The port fed its inputs rounded to bfloat16, judged against the
    reference on the float32 inputs."""
    def rounded(*args, **kw):
        args = [a.astype(np.float32) if isinstance(a, np.ndarray) else a
                for a in args]
        for i in (7, 8, 9):                     # u, v, theta
            args[i] = torch.as_tensor(args[i]).to(torch.bfloat16).float() \
                .numpy()
        return api.diag(*args, **kw)
    result, _ = helpers.run("era5_025.diag_ice", system=rounded)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", ["era5_025.diag_ice", "ral_1p5km.coupled"])
def test_control_is_judged_incorrect(cell):
    """The control: the reference computed in bfloat16 in the program's
    place."""
    from portbench import harness
    ctx = helpers.context(cell)
    path = harness.load_module("paths", ctx.workload["path"])
    ctx.system = path.control_system(ctx)
    result, _ = harness.run_cell(ctx)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["compared"].values())
