"""The PyTorch port's ops against the JAX package on the CPU: the same
numpy inputs go through both, with the tolerances of the JAX package's own
tests."""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.core.params import Params
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu.ops import indexing as jidx
from seabreeze_param_tpu.ops import orography as joro
from seabreeze_param_tpu.ops import ring_search as jring
from seabreeze_param_tpu.ops import trigger as jtrig
from seabreeze_param_tpu_torch.api import ring_radius
from seabreeze_param_tpu_torch.core import grid as tgrid
from seabreeze_param_tpu_torch.core import params as tparams
from seabreeze_param_tpu_torch.core.state import TriggerState, state_from_numpy
from seabreeze_param_tpu_torch.ops import coastline as tco
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops import indexing as tidx
from seabreeze_param_tpu_torch.ops import orography as toro
from seabreeze_param_tpu_torch.ops import ring_search as tring
from seabreeze_param_tpu_torch.ops import trigger as ttrig

CASES = ["small_case", "global_case"]


def T(a):
    """A CPU tensor holding a copy of ``a``."""
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("spec", [
    "small_case", "global_case",
    (721, 1440, dict(lat0=90.0, lat1=-90.0)),
    (1801, 3600, dict(descending_lat=True)),
    (10, 20, dict(lat0=5.0, lat1=0.5, lon0=100.0, lon1=110.0)),
], ids=["small", "global", "global025", "global010_desc", "tiny"])
def test_grid_copy_matches_jax(spec, request):
    """The port's Grid: coordinates, radians, the re-branched longitude, the
    cell size at 70 deg and the search radius k bit-equal to the JAX
    package's."""
    if isinstance(spec, str):
        c = request.getfixturevalue(spec)
        jg, tg = (G(lon=c["lon"], lat=c["lat"]) for G in (Grid, tgrid.Grid))
    else:
        nlat, nlon, kw = spec
        jg = Grid.regular(nlat, nlon, **kw)
        tg = tgrid.Grid.regular(nlat, nlon, **kw)
    assert tg.shape == jg.shape
    for name in ("lon", "lat", "lam", "phi", "lon_branched"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    assert tg.cell_diag_km_at70() == jg.cell_diag_km_at70()
    for maxdist in (90.0, 180.0, 500.0):
        assert tg.search_radius_cells(maxdist) == \
            jg.search_radius_cells(maxdist)


@pytest.mark.parametrize("kw", [
    {}, dict(target_plev=850.0, timestep=60.0, target_time=3.0),
    dict(maxdist=250.0, thresh_thc=1.5, exact_lon_indexing=False,
         skip_last_lat_row=False, ring_search_margin=0),
], ids=["defaults", "cadence", "switches"])
def test_params_copy_matches_jax(kw):
    """The port's Params and constants equal the JAX package's, the float32
    derived scalars bit for bit."""
    from seabreeze_param_tpu.core import grid as jgrid
    from seabreeze_param_tpu.core import params as jparams
    tp, jp = tparams.Params(**kw), jparams.Params(**kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for name in ("timestep_seconds", "target_time_seconds", "target_plev_pa"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a == b and a.dtype == b.dtype == np.float32
    assert tp.replace(maxdist=1.0).maxdist == 1.0
    for mod, ref, names in (
            (tparams, jparams, ("RAD2DEG_TRIGGER", "GMMA", "MISSING_VALUE",
                                "FAR_SENTINEL_KM")),
            (tgrid, jgrid, ("EARTH_RADIUS_KM", "PI_F32", "DEG2RAD_F32",
                            "RAD2DEG_F32"))):
        for name in names:
            a, b = getattr(mod, name), getattr(ref, name)
            assert a == b and a.dtype == b.dtype, name


def test_index_maps_match_jax():
    for n, pad in ((7, 3), (5, 9), (64, 1)):
        for name in ("lat_index_clamped", "lon_index_quirky",
                     "lon_index_periodic"):
            np.testing.assert_array_equal(
                tidx.pad_indices(n, pad, getattr(tidx, name)),
                jidx.pad_indices(n, pad, getattr(jidx, name)))


@pytest.mark.parametrize("exact_lon", [True, False])
@pytest.mark.parametrize("pad", [(1, 1), (6, 10), (70, 70)],
                         ids=["one", "ring", "degenerate"])
def test_pad2d_matches_jax(small_case, exact_lon, pad):
    """Bit-equal, both lon maps; (70, 70) on the 64x64 world takes the
    degenerate-gather branch."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3,) + small_case["lsm"].shape).astype(np.float32)
    got = tidx.pad2d(T(f), *pad, exact_lon=exact_lon)
    ref = jidx.pad2d(jnp.asarray(f), *pad, exact_lon=exact_lon)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_ci", [True, False])
def test_mask_and_edges_match_jax(case, with_ci, request):
    c = request.getfixturevalue(case)
    ci = c["ci_t"][-1] if with_ci else None
    tci = None if ci is None else T(ci)
    np.testing.assert_array_equal(_np(tco.make_mask(T(c["lsm"]), tci)),
                                  _np(jco.make_mask(c["lsm"], ci)))
    np.testing.assert_array_equal(_np(tco.get_edges(T(c["lsm"]), tci)),
                                  _np(jco.get_edges(c["lsm"], ci)))


@pytest.mark.parametrize("case", CASES)
def test_distance_tables_and_pass1_match_jax(case, request):
    """Host tables and pass-1 Mmin: bit-equal."""
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    tg = tgrid.Grid(lon=c["lon"], lat=c["lat"])
    k = tdist.effective_radius(tg, 180.0)
    assert k == jdist.effective_radius(grid, 180.0)
    tabs = tdist.distance_tables(tg, k)
    for a, b in zip(tabs, jdist.distance_tables(grid, k)):
        np.testing.assert_array_equal(a, b)
    coast = jco.get_edges(c["lsm"], c["ci_t"][0])
    ref, _ = jdist.pass1_extrema(jdist.pad_coast(coast, k), tabs[2], k)
    cpad = tdist.pad_coast(T(np.asarray(coast)), k)
    np.testing.assert_array_equal(_np(cpad), _np(jdist.pad_coast(coast, k)))
    got = tdist.pass1_extrema(cpad, T(tabs[2]), k)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("case", CASES)
def test_coast_distance_matches_jax(case, request):
    """Sign and 12000-km sentinel structure equal, then rtol 2e-5, atol
    2e-3 (tests/test_ops_golden.py)."""
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = jco.get_edges(c["lsm"], c["ci_t"][0])
    ref = _np(jdist.coast_distance(coast, c["lsm"], grid, 180.0))
    got = _np(tdist.coast_distance(T(np.asarray(coast)), T(c["lsm"]),
                                   tgrid.Grid(lon=c["lon"], lat=c["lat"]),
                                   180.0))
    sent = np.float32(12000.0)
    np.testing.assert_array_equal(got == sent, ref == sent)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    sel = ref != sent
    np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_sigmoid_and_t0_match_jax(case, request):
    """The sigmoid: rtol 1e-6 against the same formula in float64, and
    rtol 2e-6 against the JAX package, whose float32 sum of squares lands
    1.3e-6 (relative) off the exact value on small_case where torch's
    pairwise sum lands 1.4e-8 off.  t0: rtol 1e-6 against the JAX package.
    """
    c = request.getfixturevalue(case)
    smod_j = joro.sigmoid_weight(c["std"])
    smod_t = toro.sigmoid_weight(T(c["std"]))
    a = c["std"].astype(np.float64)
    s = 2.0 / np.sqrt(((a - a.mean()) ** 2).sum() / a.size)
    exact = 1.0 / (1.0 + np.exp(-s * (a - (a.max() - a.min()) / 4.0)))
    np.testing.assert_allclose(_np(smod_t), exact, rtol=1e-6)
    np.testing.assert_allclose(_np(smod_t), _np(smod_j), rtol=2e-6)
    theta = c["theta_t"][0]
    np.testing.assert_allclose(
        _np(ttrig.sea_level_temperature(T(theta), T(c["z"]), smod_t)),
        _np(jtrig.sea_level_temperature(theta, c["z"], smod_j)), rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pres_dim", [1, 3])
def test_wind_at_level_matches_jax(case, pres_dim, request):
    """ws rtol 1e-6, wd atol 1e-3 deg; 3-D pressure varies per column so
    the nearest level differs across the grid."""
    c = request.getfixturevalue(case)
    p = c["p"]
    if pres_dim == 3:
        rng = np.random.default_rng(1)
        p = (p[:, None, None] * (1.0 + 0.3 * rng.random(
            (1,) + c["lsm"].shape))).astype(np.float32)
    u, v = c["u_t"][0], c["v_t"][0]
    ws_t, wd_t = ttrig.wind_at_level(T(u), T(v), T(p),
                                     tparams.Params().target_plev_pa)
    ws_j, wd_j = jtrig.wind_at_level(u, v, p, Params().target_plev_pa)
    np.testing.assert_allclose(_np(ws_t), _np(ws_j), rtol=1e-6)
    np.testing.assert_allclose(_np(wd_t), _np(wd_j), rtol=0, atol=1e-3)


def test_cadence_matches_jax_state_rule():
    params = Params()
    for tt in range(1, 40):
        upd = jnp.mod(jnp.float32(tt) * params.timestep_seconds,
                      params.target_time_seconds) < jnp.float32(1.0e-4)
        assert ttrig.cadence(tt, tparams.Params()) == (tt < 2, bool(upd))


@pytest.mark.parametrize("case", CASES)
def test_ring_radius_matches_jax(case, request):
    """The NumPy copy equals the JAX package's helper, and the frame-
    widening probe of the port's diag equals the full-frame result."""
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = jco.get_edges(c["lsm"], c["ci_t"][-1])
    cd = _np(jdist.coast_distance(coast, c["lsm"], grid, 180.0))
    ref = jring.required_ring_radius_host(cd, 180.0)
    assert tring.required_ring_radius_host(cd, 180.0) == ref
    assert ring_radius(cd, tparams.Params(),
                       jdist.effective_radius(grid, 180.0)) == ref


def test_state_round_trip_is_bit_equal():
    rng = np.random.default_rng(2)
    thc, ws, wd = (rng.standard_normal((5, 7)).astype(np.float32)
                   for _ in range(3))
    st = state_from_numpy(4, thc, ws, wd, "cpu")
    assert isinstance(st, TriggerState) and st.shape == (5, 7)
    tt, thc2, ws2, wd2 = st.to_numpy()
    assert tt == 4
    for a, b in ((thc, thc2), (ws, ws2), (wd, wd2)):
        np.testing.assert_array_equal(a, b)
    ws[0, 0] += 1.0          # the state owns copies, not views
    assert st.windspeed[0, 0] != ws[0, 0]
    z = TriggerState.zeros((3, 4), "cpu")
    assert z.tt == 1 and z.windspeed.data_ptr() != z.winddir.data_ptr()


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package
    blocked, the coupling layer, the tracer and the dummy model among
    them."""
    code = """
import sys, pkgutil, importlib
sys.modules['jax'] = None
sys.modules['seabreeze_param_tpu'] = None
import seabreeze_param_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
loaded = {k.split('.')[0] for k, v in sys.modules.items() if v is not None}
assert not loaded & {'jax', 'seabreeze_param_tpu'}, loaded
want = {pkg.__name__ + '.' + n for n in (
    'coupling', 'utils.tracing', 'examples.dummy_model')}
assert want <= set(names), sorted(want - set(names))
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 17
