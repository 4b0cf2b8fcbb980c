"""The port's pass-1 lon form ``'nearest'`` against the JAX package's, on
the CPU.

On a uniform global lon axis the window minimum of pass 1 sits at the
nearest coast cell, which ``ops.distance.pass1_extrema_nearest`` finds by
min-plus doubling instead of 2k+1 taps.  Each test makes its inputs from a
seed with numpy (the conftest's worlds) and holds the port against the
JAX package on them:

* ``pass1_extrema_nearest``: the empty windows (BIG) equal to JAX's, then
  rtol 1e-6 against JAX's form (the two take sin through different
  libraries) and rtol 1e-4 / atol 1e-9 against the port's taps
  (``tests/test_ops_golden.py:142-187``);
* ``uniform_half_dlam`` equal to JAX's, ``None`` where JAX gives ``None``;
* ``coast_distance(lon_form='nearest')``: the sentinel structure equal,
  then rtol 2e-5 / atol 2e-3 km against JAX's, for every ``impl`` (on the
  CPU each kernel wrapper takes its plain version; ``'fused'`` runs B3's
  taps, as JAX's ``'pallas'`` does);
* the ``ValueError`` of both packages on a regional axis, on k * dlam >
  180 deg and on an unknown form;
* ``TriggerPipeline(distance_lon_form='nearest').run`` over two steps
  against JAX at the per-step tolerance (MISSING structure equal, then
  rtol 2e-5 / atol 2e-4), the final state as ``tests/test_torch_pipeline.
  py`` holds ``diag``'s; ``ShardedPipeline`` on 2 x 2 against JAX's at the
  decomposed run's tolerance;
* the helpers the port gained beside the form: ``min_haversine_param``,
  ``TriggerState.zeros(tt=)`` and ``remap_lon_quirky``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.core.params import Params as JParams
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline as JPipe
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu.ops import indexing as jidx
from seabreeze_param_tpu.parallel.mesh import make_mesh as jmake_mesh
from seabreeze_param_tpu.parallel.sharded import ShardedPipeline as JSharded
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops import indexing as tidx
from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

BIG = np.float32(1.0e30)
SENTINEL = np.float32(12000.0)
MISSING = np.float32(2.0e20)
NSTEPS = 2


def _coast(c, step=0):
    """The world's coastline at ``step`` (numpy, from the JAX package) and
    its global grid in both packages."""
    coast = np.array(jco.get_edges(c["lsm"], c["ci_t"][step]))
    return coast, Grid(lon=c["lon"], lat=c["lat"]), JGrid(lon=c["lon"],
                                                          lat=c["lat"])


@pytest.mark.parametrize("k", [1, 3, 6, 15, 60])
def test_pass1_nearest_matches_jax_and_taps(global_case, k):
    """k = 1 (one doubling round) to 60 (six rounds, k * dlam = 90 deg)."""
    coast, grid, jgrid = _coast(global_case)
    half = tdist.uniform_half_dlam(grid, k)
    assert half == jdist.uniform_half_dlam(jgrid, k)
    cpad = jdist.pad_coast(jnp.asarray(coast), k)
    ref, ref_none = jdist.pass1_extrema_nearest(cpad, k, half)
    ref = np.asarray(ref)
    tpad = tdist.pad_coast(torch.as_tensor(coast), k)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(cpad))
    got, none = tdist.pass1_extrema_nearest(tpad, k, half)
    assert none is None and ref_none is None
    got = got.numpy()
    empty = ref > BIG / 2
    assert empty.any() and not empty.all()
    np.testing.assert_array_equal(got > BIG / 2, empty)
    np.testing.assert_allclose(got[~empty], ref[~empty], rtol=1e-6, atol=0)
    # against the exact tapped form: the same windows, the same positions
    sdlam2 = torch.as_tensor(tdist.distance_tables(grid, k)[2])
    taps, _ = tdist.pass1_extrema(tpad, sdlam2, k)
    taps = taps.numpy()
    np.testing.assert_array_equal(taps > BIG / 2, empty)
    np.testing.assert_allclose(got[~empty], taps[~empty], rtol=1e-4,
                               atol=1e-9)


def test_uniform_half_dlam_matches_jax(global_case):
    """Global uniform axes (with and without k, up to k * dlam = 180 deg),
    a regional axis, a non-uniform axis and a one-column axis."""
    lat = global_case["lat"]
    rng = np.random.default_rng(4)
    jitter = np.linspace(0.0, 360.0, 240, endpoint=False) + 0.2 * rng.random(
        240)
    axes = {
        "global": (global_case["lon"], (None, 1, 119, 120, 121)),
        "global 0.25": (np.arange(1440, dtype=np.float32) * 0.25,
                        (None, 6, 720, 721)),
        "regional": (np.linspace(100.0, 132.0, 64, endpoint=False),
                     (None, 3)),
        "non-uniform": (jitter, (None, 3)),
        "one column": (np.array([10.0]), (None,)),
    }
    for name, (lon, ks) in axes.items():
        lon = np.asarray(lon, np.float32)
        for k in ks:
            got = tdist.uniform_half_dlam(Grid(lon=lon, lat=lat), k)
            ref = jdist.uniform_half_dlam(JGrid(lon=lon, lat=lat), k)
            assert (got is None) == (ref is None), (name, k)
            if ref is not None:
                assert got.dtype == np.float32 and got == ref, (name, k)
    assert tdist.uniform_half_dlam(Grid(lon=global_case["lon"], lat=lat),
                                   121) is None


def _distance_close(got, ref):
    """Sentinel structure equal, then rtol 2e-5 / atol 2e-3 km."""
    sent = ref == SENTINEL
    assert (~sent).any()
    np.testing.assert_array_equal(got == SENTINEL, sent)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_allclose(got[~sent], ref[~sent], rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("impl", ["plain", "hybrid", "auto", "xla"])
@pytest.mark.parametrize("maxdist", [180.0, 600.0])
def test_coast_distance_nearest_matches_jax(global_case, impl, maxdist):
    """The port's nearest form through each CPU route against the JAX
    package's ``impl='xla'`` nearest form (k = 1 at 180 km, 3 at 600 km on
    this 1.5-degree grid)."""
    c = global_case
    coast, grid, jgrid = _coast(c, step=1)
    ref = np.asarray(jdist.coast_distance(coast, c["lsm"], jgrid, maxdist,
                                          impl="xla", lon_form="nearest"))
    got = tdist.coast_distance(torch.as_tensor(coast),
                               torch.as_tensor(c["lsm"]), grid, maxdist,
                               impl=impl, lon_form="nearest").numpy()
    _distance_close(got, ref)


def test_coast_distance_nearest_fused_runs_taps(global_case):
    """``'fused'`` (and the JAX name ``'pallas'``) checks the form and runs
    B3's taps, as the JAX package's ``'pallas'`` does: equal, bit for bit,
    to the taps form, and within the distance tolerance of JAX's."""
    c = global_case
    coast, grid, jgrid = _coast(c, step=1)
    args = (torch.as_tensor(coast), torch.as_tensor(c["lsm"]), grid, 600.0)
    taps = tdist.coast_distance(*args, impl="fused").numpy()
    for impl in ("fused", "pallas"):
        got = tdist.coast_distance(*args, impl=impl, lon_form="nearest")
        np.testing.assert_array_equal(got.numpy(), taps)
    ref = np.asarray(jdist.coast_distance(coast, c["lsm"], jgrid, 600.0,
                                          impl="xla", lon_form="taps"))
    _distance_close(taps, ref)


def test_lon_form_value_errors(small_case, global_case):
    """Both packages raise ``ValueError`` on a regional axis, on k * dlam >
    180 deg (k = 121 on a 1.5-degree axis) and on an unknown form; the
    pipelines raise where they first compute a distance, the decomposed
    runs when they are built."""
    def both(c, **kw):
        coast, grid, jgrid = _coast(c)
        with pytest.raises(ValueError) as ref:
            jdist.coast_distance(coast, c["lsm"], jgrid, 180.0, **kw)
        with pytest.raises(ValueError) as got:
            tdist.coast_distance(torch.as_tensor(coast),
                                 torch.as_tensor(c["lsm"]), grid, 180.0,
                                 **kw)
        return str(ref.value), str(got.value)

    ref, got = both(small_case, lon_form="nearest")
    assert got == ref and "uniform global lon axis" in got
    ref, got = both(global_case, lon_form="nearest", k=121)
    assert got == ref
    ref, got = both(global_case, lon_form="farthest")
    assert "farthest" in ref and "farthest" in got
    # k = 120 is a half-circle exactly: taken
    coast, grid, _ = _coast(global_case)
    tdist.coast_distance(torch.as_tensor(coast),
                         torch.as_tensor(global_case["lsm"]), grid, 180.0,
                         k=120, lon_form="nearest")

    c = small_case
    lsm = torch.as_tensor(c["lsm"])
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]), device="cpu",
                           distance_lon_form="nearest")
    with pytest.raises(ValueError, match="uniform global lon axis"):
        pipe.distance_field(lsm)
    jpipe = JPipe(JGrid(lon=c["lon"], lat=c["lat"]),
                  distance_lon_form="nearest")
    with pytest.raises(ValueError, match="uniform global lon axis"):
        jpipe.distance_field(c["lsm"])
    with pytest.raises(ValueError, match="distance_lon_form='nearest'"):
        ShardedPipeline(pipe, make_mesh((2, 2), "cpu"))
    with pytest.raises(ValueError, match="distance_lon_form='nearest'"):
        JSharded(jpipe, jmake_mesh((2, 4)))


def _inputs(c):
    return (c["theta_t"][:NSTEPS], c["u_t"][:NSTEPS], c["v_t"][:NSTEPS],
            c["lsm"], c["z"], c["std"], c["p"])


def _outputs_close(got, ref):
    """The per-step tolerance: MISSING structure equal, then rtol 2e-5 /
    atol 2e-4."""
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        miss = r == MISSING
        np.testing.assert_array_equal(g == MISSING, miss, err_msg=key)
        np.testing.assert_allclose(g[~miss], r[~miss], rtol=2e-5, atol=2e-4,
                                   err_msg=key)


def _state_close(got, ref):
    """The final state as ``test_torch_pipeline.py`` holds ``diag``'s."""
    assert int(got.tt) == int(ref.tt)
    np.testing.assert_allclose(np.asarray(got.thc), np.asarray(ref.thc),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.windspeed),
                               np.asarray(ref.windspeed), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.winddir),
                               np.asarray(ref.winddir), rtol=0, atol=1e-3)


@pytest.mark.parametrize("maxdist", [180.0, 600.0])
def test_pipeline_nearest_run_matches_jax(global_case, maxdist):
    """``TriggerPipeline(distance_lon_form='nearest').run``, two steps with
    moving ice, against JAX's; the kernel route (the wrappers' plain
    versions on the CPU) bit-equal to the plain route."""
    c = global_case
    xs = _inputs(c)
    jstate, jout = JPipe(JGrid(lon=c["lon"], lat=c["lat"]),
                         JParams(maxdist=maxdist),
                         distance_lon_form="nearest").run(
        JState.zeros(c["lsm"].shape), *xs, ci_t=c["ci_t"][:NSTEPS])
    runs = []
    for uk in (None, True):
        pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]),
                               Params(maxdist=maxdist), device="cpu",
                               use_kernels=uk, distance_lon_form="nearest")
        runs.append(pipe.run(TriggerState.zeros(c["lsm"].shape, "cpu"),
                             *xs, ci_t=c["ci_t"][:NSTEPS]))
    (state, out), (kstate, kout) = runs
    _outputs_close({k: o.numpy() for k, o in out.items()}, jout)
    _state_close(state, jstate)
    for key in out:
        torch.testing.assert_close(kout[key], out[key], rtol=0, atol=0)
    torch.testing.assert_close(kstate.windspeed, state.windspeed, rtol=0,
                               atol=0)
    # the nearest form moves the distances, not the structure, of the taps
    taps = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]),
                           Params(maxdist=maxdist), device="cpu").run(
        TriggerState.zeros(c["lsm"].shape, "cpu"), *xs,
        ci_t=c["ci_t"][:NSTEPS])[1]
    np.testing.assert_array_equal(out["sb_con"].numpy() == MISSING,
                                  taps["sb_con"].numpy() == MISSING)


def test_sharded_nearest_matches_jax(global_case):
    """``ShardedPipeline`` on a 2 x 2 mesh with the nearest form (each
    shard's ``half_dlam`` from the global grid) against JAX's on 2 x 2
    virtual devices and against the port's single-device run, at the
    decomposed run's tolerance (MISSING structure equal, under 1e-3 of
    cells outside rtol 1e-5 / atol 1e-4, ``tests/test_sharded.py``: the
    sigmoid's statistics are summed in another order)."""
    import warnings
    c = global_case
    xs = _inputs(c)
    ci = c["ci_t"][:NSTEPS]
    jpipe = JPipe(JGrid(lon=c["lon"], lat=c["lat"]), JParams(maxdist=600.0),
                  distance_lon_form="nearest")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 4 of the 8 virtual devices
        jsp = JSharded(jpipe, jmake_mesh((2, 2)))
    assert jsp.half_dlam is not None
    jstate, jout = jsp.run(JState.zeros(c["lsm"].shape), *xs, ci_t=ci)
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]),
                           Params(maxdist=600.0), device="cpu",
                           distance_lon_form="nearest")
    sp = ShardedPipeline(pipe, make_mesh((2, 2), "cpu"))
    assert sp.half_dlam == jsp.half_dlam and sp.overlap == jsp.overlap
    state, out = sp.run(TriggerState.zeros(c["lsm"].shape, "cpu"), *xs,
                        ci_t=ci)
    single = pipe.run(TriggerState.zeros(c["lsm"].shape, "cpu"), *xs,
                      ci_t=ci)[1]
    for ref in (jout, single):
        for key in ref:
            g, r = out[key].numpy(), np.asarray(ref[key])
            miss = r == MISSING
            np.testing.assert_array_equal(g == MISSING, miss, err_msg=key)
            off = ~np.isclose(g[~miss], r[~miss], rtol=1e-5, atol=1e-4)
            assert off.mean() < 1e-3, f"{key}: {off.sum()}/{off.size}"
    np.testing.assert_allclose(state.thc.numpy(), np.asarray(jstate.thc),
                               rtol=1e-6, atol=1e-5)


def test_min_haversine_param_matches_jax(global_case):
    """``min_haversine_param`` (pad, then both passes) against JAX's."""
    coast, grid, jgrid = _coast(global_case, step=1)
    k = 3
    tabs = tdist.distance_tables(grid, k)
    ref = np.asarray(jdist.min_haversine_param(jnp.asarray(coast),
                                               *jdist.distance_tables(jgrid,
                                                                      k), k))
    got = tdist.min_haversine_param(torch.as_tensor(coast),
                                    *(torch.as_tensor(t) for t in tabs),
                                    k).numpy()
    np.testing.assert_array_equal(got > BIG / 2, ref > BIG / 2)
    sel = ref < BIG / 2
    np.testing.assert_allclose(got[sel], ref[sel], rtol=3e-7, atol=0)


def test_helpers_match_jax():
    """``TriggerState.zeros`` with and without ``tt``, and
    ``remap_lon_quirky`` on 2-D and stacked fields."""
    for tt in (None, 1, 14):
        kw = {} if tt is None else {"tt": tt}
        got = TriggerState.zeros((5, 7), "cpu", **kw)
        ref = JState.zeros((5, 7), **kw)
        assert got.tt == int(ref.tt) and isinstance(got.tt, int)
        for f in ("thc", "windspeed", "winddir"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert got.windspeed.data_ptr() != got.winddir.data_ptr()
    rng = np.random.default_rng(9)
    for shape in ((6, 9), (3, 6, 9), (4, 1)):
        a = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(
            tidx.remap_lon_quirky(torch.as_tensor(a)).numpy(),
            np.asarray(jidx.remap_lon_quirky(jnp.asarray(a))))
