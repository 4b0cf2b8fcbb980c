"""The port's whole slice on the CPU: ``diag`` against the JAX package's
``diag`` and against the NumPy oracle, the pipeline's kernel path (whose
wrappers take their plain versions on CPU tensors) against its plain path,
and the API's probes (``tests/test_diag_e2e.py``'s contract)."""
import warnings

import numpy as np
import pytest
import torch

from seabreeze_param_tpu.api import diag as jdiag
from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from tests.golden.reference_numpy import F, golden_diag_sequence

MISSING = F(2.0e20)


def _args(c, nsteps, with_ci=True):
    return (1, c["lsm"], c["z"], c["std"], c["lon"], c["lat"], c["p"],
            c["u_t"][:nsteps], c["v_t"][:nsteps], c["theta_t"][:nsteps],
            c["ci_t"][:nsteps] if with_ci else None)


def _sb_close(got, ref, nlat):
    """MISSING structure equal on the computed rows; sb mismatch fraction
    below 2e-3 at rtol = atol = 5e-4 (tests/test_diag_e2e.py)."""
    miss_r, miss_g = ref == MISSING, got == MISSING
    np.testing.assert_array_equal(miss_g[:, :nlat - 1], miss_r[:, :nlat - 1])
    sel = (~miss_r) & (np.arange(nlat)[None, :, None] < nlat - 1)
    mism = ~np.isclose(got[sel], ref[sel], rtol=5e-4, atol=5e-4)
    assert mism.mean() < 2e-3, f"{mism.sum()} / {mism.size}"


@pytest.mark.parametrize("case,nsteps", [("small_case", 4),
                                         ("global_case", 2)])
@pytest.mark.parametrize("with_ci", [True, False])
def test_diag_matches_jax_diag(case, nsteps, with_ci, request):
    c = request.getfixturevalue(case)
    args = _args(c, nsteps, with_ci)
    ref = jdiag(*args, full_output=True)
    got = diag(*args, device="cpu", full_output=True)
    assert got[0] == ref[0] == 1 + nsteps
    nlat = len(c["lat"])
    _sb_close(got[1], np.asarray(ref[1]), nlat)
    np.testing.assert_array_equal(got[1] == MISSING,
                                  np.asarray(ref[1]) == MISSING)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-3)
    for key in ("t0", "windspeed", "winddir"):
        np.testing.assert_allclose(got[5][key], np.asarray(ref[5][key]),
                                   rtol=1e-5, atol=1e-3, err_msg=key)


def test_diag_matches_golden_sequence(small_case):
    """The NumPy oracle with the tolerances of tests/test_diag_e2e.py."""
    c = small_case
    nsteps, nlat = 4, len(c["lat"])
    ref = golden_diag_sequence(nsteps, c["p"], c["z"], c["std"],
                               c["theta_t"], c["v_t"], c["u_t"], c["lsm"],
                               c["ci_t"], c["lon"], c["lat"])
    tt, sb, thc, ws, wd = diag(*_args(c, nsteps), device="cpu")
    assert tt == 1 + nsteps
    _sb_close(sb, ref[0], nlat)
    np.testing.assert_allclose(thc[:-1], ref[1, -1][:-1], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ws[:-1], ref[2, -1][:-1], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(wd[:-1], ref[3, -1][:-1], rtol=1e-3,
                               atol=0.2)


@pytest.mark.parametrize("with_ci", [True, False])
def test_kernel_path_matches_plain_path(small_case, with_ci):
    """The stacked kernel path (pre-filled stacks, ever-coastal mask, wind
    state updated in place) against the plain path over a scan from tt=14
    across the tt=15 wind refresh; the caller's state is left alone."""
    c = small_case
    grid = Grid(lon=c["lon"], lat=c["lat"])
    rng = np.random.default_rng(5)
    shape = c["lsm"].shape
    ws0 = torch.tensor((5 + rng.random(shape)).astype(F))
    state = TriggerState(tt=14, thc=torch.zeros(shape), windspeed=ws0,
                         winddir=torch.tensor(
                             (360 * rng.random(shape) - 180).astype(F)))
    keep = ws0.clone()
    args = (c["theta_t"][:3], c["u_t"][:3], c["v_t"][:3], c["lsm"], c["z"],
            c["std"], c["p"])
    ci = c["ci_t"][:3] if with_ci else None
    runs = [TriggerPipeline(grid, device="cpu", use_kernels=uk).run(
        state, *args, ci_t=ci) for uk in (True, False)]
    assert TriggerPipeline(grid, device="cpu").kernels is False
    (ks, ko), (ps, po) = runs
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        torch.testing.assert_close(ko[key], po[key], rtol=0, atol=0)
    assert ks.tt == ps.tt == 17
    for a, b in ((ks.thc, ps.thc), (ks.windspeed, ps.windspeed),
                 (ks.winddir, ps.winddir)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(state.windspeed, keep, rtol=0, atol=0)


def test_single_steps_with_threaded_state_equal_one_call(small_case):
    """3-D per-step calls threading (thc, ws, wd) equal one 4-D call."""
    c = small_case
    _, sb_batch, thc_b, ws_b, wd_b = diag(*_args(c, 3), device="cpu")
    tt, thc, ws, wd = 1, None, None, None
    sbs = []
    for ts in range(3):
        kw = {} if ts == 0 else dict(thc=thc, ws=ws, wd=wd)
        tt, sb, thc, ws, wd = diag(
            tt, c["lsm"], c["z"], c["std"], c["lon"], c["lat"], c["p"],
            c["u_t"][ts], c["v_t"][ts], c["theta_t"][ts], c["ci_t"][ts],
            device="cpu", **kw)
        assert sb.shape == (1,) + c["lsm"].shape
        sbs.append(sb[0])
    assert tt == 4
    np.testing.assert_array_equal(np.stack(sbs), sb_batch)
    np.testing.assert_array_equal(ws, ws_b)


def test_diag_api_probes(small_case):
    """Unknown kwarg, shape errors, missing-state warning, tt clamp, masked
    sea ice, the mesh= branch, and the bounded pipeline cache."""
    c = small_case
    base = _args(c, 1)
    with pytest.raises(TypeError, match="bogus"):
        diag(*base, device="cpu", bogus=1)
    with pytest.raises(ValueError, match="theta: got"):
        diag(*base[:9], c["theta_t"][:1, :, :-2], base[10], device="cpu")
    with pytest.raises(ValueError, match="ci: got"):
        diag(*_args(c, 2)[:10], c["ci_t"][:1], device="cpu")
    meshed = diag(*base, device="cpu", mesh=(2, 2))
    plain = diag(*base, device="cpu")
    assert meshed[0] == plain[0] == 2
    np.testing.assert_array_equal(meshed[1] == MISSING, plain[1] == MISSING)
    np.testing.assert_allclose(meshed[3], plain[3], rtol=1e-6, atol=1e-5)
    with pytest.warns(UserWarning, match="previous timestep"):
        diag(5, *base[1:], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt0 = diag(0, *base[1:], device="cpu")
    assert tt0[0] == 2
    ci = c["ci_t"][2:3]
    masked = np.ma.masked_array(ci, mask=ci > 0.5)
    a = diag(*base[:10], masked, device="cpu")
    b = diag(*base[:10], masked.filled(0), device="cpu")
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    hot = diag(*base, device="cpu", thresh_thc=50.0)[1]
    assert ((hot == 0) | (hot == MISSING)).all()
    api.clear_exec_cache()
    for m in (170.0, 175.0, 180.0, 185.0, 190.0, 195.0, 200.0, 205.0, 210.0):
        diag(*base, device="cpu", maxdist=m)
    assert len(api._CACHE) <= api._CACHE_MAX
    assert api.CACHE_STATS["pipeline_misses"] >= 9
