"""The port at ring radii past 57, on the CPU, against the JAX package.

Two regional worlds near the equator: 80 x 96 cells at 0.015 degrees
(about 1.5 km, the spacing of convection-permitting regional models), where
the distance search reaches k = 76 cells and the ring search NN = 80; and
48 x 256 cells at 0.0045 degrees (0.5 km), where k = 254 and NN = 258, past
the 243 of a 1 km grid at 54 N (``tools/ring_nn.py``).  On the card the ring
kernels take such radii with their large build (``csrc/ring_trigger.cu``,
held bit-equal to the plain versions by ``tests/test_torch_cuda.py``); on the
CPU every wrapper takes its plain version, so these cases pin the behaviour
the large build is held to: ``diag`` (plain route, and the kernel route whose
wrappers run plain here) on both worlds, and the coupled step
(``prepare_mask`` + ``physics``, 1-D and 3-D pressure) on the first, over
two steps.  Tolerances (ROADMAP):
MISSING structure equal, then rtol 2e-5 / atol 2e-4; the final wind
bit-equal wherever both packages' fresh winds agree bit for bit (XLA
contracts u*u + v*v into an FMA inside its jitted step).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu import coupling as jcoup
from seabreeze_param_tpu.api import diag as jdiag
from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.ops import trigger as jtrig
from seabreeze_param_tpu_torch import coupling as tcoup
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.core.state import state_from_numpy
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops import trigger as ttrig

MISSING = np.float32(2.0e20)
NSTEPS = 2
#: name: (nlat, nlon, spacing in degrees, the least NN diag must run at)
WORLDS = {"80x96": (80, 96, 0.015, 58), "48x256": (48, 256, 0.0045, 244)}


@functools.cache
def world(name="80x96"):
    """``make_world`` fields of one of :data:`WORLDS` from 1.2 N southward,
    and its coordinates."""
    nlat, nlon, spacing, _ = WORLDS[name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, NSTEPS,
                                                    seed=3)
    lat = np.linspace(1.2, 1.2 - (nlat - 1) * spacing, nlat).astype(
        np.float32)
    lon = np.linspace(0.0, nlon * spacing, nlon, endpoint=False).astype(
        np.float32)
    return lsm, z, std, pres, theta, u, v, ci, lat, lon


@functools.cache
def jax_diag(name):
    """JAX ``diag`` of world ``name`` over its steps (full output).  The
    48 x 256 world runs op by op (``jax.disable_jit``): there XLA takes
    minutes on the CPU to compile the ring loop at NN = 258, and op by op
    is the same arithmetic (it may differ from the jitted step by FMA
    contraction, which the tolerances below cover)."""
    lsm, z, std, pres, theta, u, v, ci, lat, lon = world(name)
    args = (1, lsm, z, std, lon, lat, pres, u, v, theta, ci)
    if name == "80x96":
        return jdiag(*args, full_output=True)
    with jax.disable_jit():
        return jdiag(*args, full_output=True)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, what):
    got, ref = _np(got), _np(ref)
    miss = ref == MISSING
    np.testing.assert_array_equal(got == MISSING, miss, err_msg=what)
    np.testing.assert_allclose(got[~miss], ref[~miss], rtol=2e-5, atol=2e-4,
                               err_msg=what)


def _fresh_wind_agrees(u, v, pres):
    """Where the two packages' fresh (speed, direction) at the target level
    are equal bit for bit at every step.  Whether XLA contracts depends on
    what it fuses, so JAX's wind is taken both op by op and jitted, and a
    cell agrees only where the port's equals both."""
    target = Params().target_plev_pa
    jwind = jax.jit(jtrig.wind_at_level, static_argnums=3)
    ok = [True, True]
    for t in range(len(u)):
        got = ttrig.wind_at_level(*(torch.as_tensor(a) for a in (u[t], v[t],
                                                                 pres)),
                                  target)
        for ref in (jtrig.wind_at_level(u[t], v[t], pres, target),
                    jwind(u[t], v[t], pres, target)):
            ok = [o & (_np(g) == _np(r)) for o, g, r in zip(ok, got, ref)]
    return ok


def _final_wind(got_ws, got_wd, ref_ws, ref_wd, agree):
    """Bit-equal where the fresh winds agree; within rtol 1e-6 (speed) and
    atol 1e-3 deg (direction) elsewhere."""
    for g, r, ok, tol, what in ((got_ws, ref_ws, agree[0],
                                 dict(rtol=1e-6, atol=0), "windspeed"),
                                (got_wd, ref_wd, agree[1],
                                 dict(rtol=0, atol=1e-3), "winddir")):
        g, r = _np(g), _np(r)
        assert ok.mean() > 0.5, what
        np.testing.assert_array_equal(g[ok], r[ok], err_msg=what)
        np.testing.assert_allclose(g, r, err_msg=what, **tol)


@pytest.mark.parametrize("name,path", [
    *(pytest.param("80x96", p, id=p) for p in (
        "diag", "diag_kernel_route", "coupled_1d", "coupled_3d")),
    *(pytest.param("48x256", p, id=f"48x256-{p}") for p in (
        "diag", "diag_kernel_route"))])
def test_large_nn_matches_jax(name, path):
    lsm, z, std, pres, theta, u, v, ci, lat, lon = world(name)
    nn = TriggerPipeline(Grid(lon=lon, lat=lat), device="cpu").nn_max
    assert nn >= WORLDS[name][3], nn
    if path.startswith("diag"):
        args = (1, lsm, z, std, lon, lat, pres, u, v, theta, ci)
        ref = jax_diag(name)
        got = diag(*args, device="cpu", full_output=True,
                   use_kernels=path == "diag_kernel_route")
        assert got[0] == ref[0] == 1 + NSTEPS
        _close(got[1], ref[1], "sb_con")
        for key in ("sb_con", "t0", "windspeed", "winddir"):
            _close(got[5][key], ref[5][key], key)
        _close(got[2], ref[2], "thc")
        _final_wind(got[3], got[4], ref[3], ref[4],
                    _fresh_wind_agrees(u, v, pres))
        return

    # the coupled step: each package's own mask and physics, two steps
    if path == "coupled_3d":
        rng = np.random.default_rng(5)
        pres = (pres[:, None, None] * (1.0 + 0.3 * rng.random(
            (1,) + lsm.shape))).astype(np.float32)
    jct = jcoup.CoupledTrigger(grid=JGrid(lon=lon, lat=lat))
    tct = tcoup.CoupledTrigger(grid=Grid(lon=lon, lat=lat), device="cpu")
    assert tct.pipeline().nn_max == nn
    zeros = np.zeros(lsm.shape, np.float32)
    jstate = JState(tt=jnp.int32(1), thc=jnp.asarray(zeros),
                    windspeed=jnp.asarray(zeros), winddir=jnp.asarray(zeros))
    tstate = state_from_numpy(1, zeros, zeros, zeros, "cpu")
    for t in range(NSTEPS):
        jmask = jct.prepare_mask(lsm, ci[t])
        tmask = tct.prepare_mask(lsm, ci[t])
        sent = np.float32(12000.0)
        np.testing.assert_array_equal(_np(tmask) == sent, _np(jmask) == sent)
        np.testing.assert_array_equal(np.sign(_np(tmask)),
                                      np.sign(_np(jmask)))
        jstate, jout = jct.physics(jstate, pres, u[t], v[t], theta[t], z,
                                   std, jmask)
        tstate, tout = tct.physics(tstate, pres, u[t], v[t], theta[t], z,
                                   std, tmask)
        for key in jout:
            _close(tout[key], jout[key], f"step {t} {key}")
    assert tstate.tt == int(jstate.tt) == 1 + NSTEPS
    np.testing.assert_allclose(_np(tstate.thc), _np(jstate.thc), rtol=1e-6)
    _final_wind(tstate.windspeed, tstate.winddir, jstate.windspeed,
                jstate.winddir, _fresh_wind_agrees(u, v, pres))


def test_ring_thc_past_2047_matches_jax():
    """The ring search at NN = 2048, one past the widest radius whose
    window's cell count, (2 NN + 1)^2, is below 2^24: an 8 x 16 field of
    land cells all within maxdist (cdist >= 0 everywhere), so no window
    ever holds both classes and every cell latches the NN window, whose
    land count the float32 running sum rounds.  The port's plain version
    (what kernels B1, B4 and B5 are held to, bit for bit, on the card)
    against JAX's ``ring_thc`` run op by op (``jax.disable_jit``: XLA
    would take minutes to compile the 2048-radius loop), bit for bit."""
    from seabreeze_param_tpu.ops import ring_search as jring
    from seabreeze_param_tpu_torch.ops import ring_search as tring
    nn = 2048
    rng = np.random.default_rng(2048)
    t0 = (280.0 + 10.0 * rng.random((8, 16))).astype(np.float32)
    cd = (50.0 + 100.0 * rng.random((8, 16))).astype(np.float32)
    got, found = tring.ring_thc(torch.as_tensor(t0), torch.as_tensor(cd), nn,
                                maxdist=180.0)
    with jax.disable_jit():
        ref, jfound = jring.ring_thc(t0, cd, nn, maxdist=180.0)
    assert not found.any() and not np.asarray(jfound).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the window's exact cell count is no float32: the count rounds
    cells = (2 * nn + 1) ** 2
    assert cells > 2 ** 24 and float(np.float32(cells)) != cells
