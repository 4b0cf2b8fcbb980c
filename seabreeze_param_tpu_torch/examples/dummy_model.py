"""Model-coupling skeleton, the ``dummy_model`` equivalent; counterpart of
the repo's ``examples/dummy_model.py``.

The reference ships a Fortran fake model (``generic/dummy_model.f90:24-56``
with the field registry ``generic/get_all_fields_mod.f90:6-21``) to show
the coupling contract: every atmosphere step runs

    get_edges -> get_dist -> physics(seabreeze_diag)

before the next dynamics step, threading the trigger state forward.  Here a
toy "dynamics" (advecting temperature, rotating wind) in torch alternates
with ``TriggerPipeline.step`` (kernels B2 and B4 on the card), on the
reference dummy grid (nx=128, ny=96, 8 pressure levels).  ``--sharded``
runs the decomposed pipeline instead (``ShardedPipeline.run`` over the
fields repeated ``steps`` times, static coastline, as the JAX example does)
on a ``--mesh=PYxPX`` mesh (default ``auto``) over every visible card, over
``--device``'s one device, or over its comma-separated list (one group of
shards per entry).

Run:  python -m seabreeze_param_tpu_torch.examples.dummy_model [--steps=N]
      [--device=cpu|cuda:0,cuda:1] [--sharded [--mesh=2x4]]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

# Field registry (generic/get_all_fields_mod.f90:6-21): grid constants and
# the canonical coupled-field set.
NX, NY, NZ = 128, 96, 8          # lon, lat, plev (56 model levels -> 8 p)


def init_fields(seed=0):
    """The get_all_fields equivalent: allocate + initialise everything, as
    host float32 arrays (the same numbers as the JAX example's)."""
    rng = np.random.default_rng(seed)
    F = np.float32
    y, x = np.mgrid[0:NY, 0:NX]
    coastx = 0.55 * NX + 0.1 * NX * np.sin(2 * np.pi * y / NY * 2.0)
    land = (x > coastx).astype(F)
    return dict(
        land_frac=(land * (0.6 + 0.4 * rng.random((NY, NX)))).astype(F),
        ice_frac=np.zeros((NY, NX), F),
        z=(700.0 * land * rng.random((NY, NX))).astype(F),
        sigma=(110.0 * land * rng.random((NY, NX))).astype(F),
        p=np.linspace(100000.0, 30000.0, NZ).astype(F),
        u=(6.0 * rng.standard_normal((NZ, NY, NX))).astype(F),
        v=(6.0 * rng.standard_normal((NZ, NY, NX))).astype(F),
        theta=(288.0 + 5.0 * rng.standard_normal((NY, NX))
               + 4.0 * land).astype(F),
    )


def atmos_step(state, theta, u, v, pipe, fields_static):
    """One coupled step: toy dynamics, then the trigger physics (the
    dummy_model.f90:27-37 call sequence).  Returns the new (state, theta,
    u, v) and the step's sb_con."""
    # -- fake dynamics: shift theta eastward, precess the wind ----------
    theta = torch.roll(theta, 1, dims=-1)
    cs, sn = float(np.float32(np.cos(0.05))), float(np.float32(np.sin(0.05)))
    u, v = cs * u - sn * v, sn * u + cs * v
    # -- physics: coastline -> distance -> trigger ----------------------
    lsm, z, sigma, pres, ci = fields_static
    new_state, outs = pipe.step(state, theta, u, v, lsm, z, sigma, pres,
                                ci=ci)
    return (new_state, theta, u, v), outs["sb_con"]


def run(steps=12, sharded=False, device=None, use_kernels=None,
        mesh="auto"):
    """``steps`` coupled steps from :func:`init_fields` (``sharded``: the
    decomposed run on ``mesh``).  ``device`` as ``api.diag``'s: None, the
    current card (for ``sharded`` every visible card); one device; or a
    list, a mesh over those devices (one group of shards each).  Returns
    the final state and the (steps, NY, NX) stack of sb_con, on the (first)
    device."""
    from ..core.grid import Grid
    from ..core.state import TriggerState
    from ..models.pipeline import TriggerPipeline

    mesh_devices = device
    if isinstance(device, (list, tuple)):
        device = device[0]
    dev = torch.device("cuda" if device is None else device)
    f = init_fields()
    grid = Grid.regular(NY, NX, lat0=60.0, lat1=-60.0)
    pipe = TriggerPipeline(grid, device=dev, use_kernels=use_kernels)
    if sharded:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedPipeline
        sp = ShardedPipeline(pipe, make_mesh(mesh, device=mesh_devices))
        rep = {k: np.repeat(f[k][None], steps, axis=0)
               for k in ("theta", "u", "v")}
        final, outs = sp.run(TriggerState.zeros((NY, NX), dev), rep["theta"],
                             rep["u"], rep["v"], f["land_frac"], f["z"],
                             f["sigma"], f["p"])
        return final, outs["sb_con"]
    statics = tuple(torch.as_tensor(f[k], device=dev) for k in
                    ("land_frac", "z", "sigma", "p", "ice_frac"))
    carry = (TriggerState.zeros((NY, NX), dev),
             *(torch.as_tensor(f[k], device=dev) for k in ("theta", "u", "v")))
    sbs = []
    for _ in range(steps):
        carry, sb = atmos_step(*carry, pipe, statics)
        sbs.append(sb)
    return carry[0], torch.stack(sbs)


def main(argv):
    steps, sharded, device, mesh = 12, False, None, "auto"
    for arg in argv:
        if arg.startswith("--steps="):
            steps = int(arg.split("=")[1])
        elif arg.startswith("--device="):
            device = arg.split("=")[1]
            if "," in device:
                device = device.split(",")
        elif arg.startswith("--mesh="):
            mesh = arg.split("=")[1]
        elif arg == "--sharded":
            sharded = True
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    t0 = time.time()
    final, sb = run(steps=steps, sharded=sharded, device=device, mesh=mesh)
    sb = sb.cpu().numpy()
    active = sb[sb < 1.0e19]
    where = ",".join(device) if isinstance(device, list) else device
    print(f"{steps} coupled steps on {NY}x{NX} ({where or 'cuda'}) in "
          f"{time.time() - t0:.1f}s (tt={final.tt})")
    print(f"sb_con: {np.count_nonzero(active)} active cells, "
          f"range [{active.min():.3f}, {active.max():.3f}]")


if __name__ == "__main__":
    main(sys.argv[1:])
