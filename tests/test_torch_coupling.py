"""The port's coupling layer, ``TriggerPipeline.step``, the dummy model and
the tracer against the JAX package on the CPU (mirrors
``tests/test_coupling.py`` and the tracing / dummy-model tests of
``tests/test_aux_subsystems.py``).  The same numpy inputs, made from a
seed, go through both.  The JAX ``CoupledTrigger`` runs its
``use_pallas=False`` path: its Pallas route has no interpret mode on the
CPU; kernel B4's plain version is held against the Pallas kernel in
``tests/test_torch_kernels_plain.py``."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu import coupling as jcoup
from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline as JPipe
from seabreeze_param_tpu.ops import trigger as jtrig
from seabreeze_param_tpu_torch import coupling as tcoup
from seabreeze_param_tpu_torch.core import params as tparams
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.state import TriggerState, state_from_numpy
from seabreeze_param_tpu_torch.examples import dummy_model as tdummy
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops import trigger as ttrig
from seabreeze_param_tpu_torch.utils.tracing import Tracer, device_info

CASES = ["small_case", "global_case"]
MISSING = np.float32(2.0e20)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grids(c):
    return (JGrid(lon=c["lon"], lat=c["lat"]),
            Grid(lon=c["lon"], lat=c["lat"]))


def _fields(c, tt, seed=13, pres_dim=1):
    """A random carried state, one step's theta, u, v and the pressure
    (3-D: a per-column perturbation that flips the nearest level)."""
    rng = np.random.default_rng(seed)
    shape = c["lsm"].shape
    nlev = len(c["p"])
    st = dict(thc=(290 + rng.standard_normal(shape)).astype(np.float32),
              ws=(5 + rng.random(shape)).astype(np.float32),
              wd=(360 * rng.random(shape) - 180).astype(np.float32))
    theta = (288 + 5 * rng.standard_normal(shape)).astype(np.float32)
    u = (6 * rng.standard_normal((nlev,) + shape)).astype(np.float32)
    v = (6 * rng.standard_normal((nlev,) + shape)).astype(np.float32)
    p = c["p"]
    if pres_dim == 3:
        p = (p[:, None, None] + 9000.0 * rng.standard_normal(
            (nlev,) + shape)).astype(np.float32)
    return st, theta, u, v, p


def _jstate(tt, st):
    return JState(tt=jnp.int32(tt), thc=jnp.asarray(st["thc"]),
                  windspeed=jnp.asarray(st["ws"]),
                  winddir=jnp.asarray(st["wd"]))


def _close(got, ref, what):
    """MISSING structure equal, then rtol 2e-5 / atol 2e-4."""
    got, ref = _np(got), _np(ref)
    miss = ref == MISSING
    np.testing.assert_array_equal(got == MISSING, miss, err_msg=what)
    np.testing.assert_allclose(got[~miss], ref[~miss], rtol=2e-5, atol=2e-4,
                               err_msg=what)


def _cdist_close(got, ref):
    """Sign and 12000-km sentinel structure equal, then rtol 2e-5 / atol
    2e-3 (tests/test_ops_golden.py)."""
    got, ref = _np(got), _np(ref)
    sent = np.float32(12000.0)
    np.testing.assert_array_equal(got == sent, ref == sent)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    sel = ref != sent
    np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5, atol=2e-3)


def _same_wind(u, v, p):
    """Where the two packages' fresh wind at the target level agrees bit
    for bit, (speed, direction).  It does not everywhere: XLA contracts
    u*u + v*v into an FMA and its atan2 differs from torch's in the last
    bit (``test_torch_ops.py::test_wind_at_level_matches_jax`` holds them
    to rtol 1e-6 and atol 1e-3 deg)."""
    target = tparams.Params().target_plev_pa
    ref = jtrig.wind_at_level(u, v, p, target)
    got = ttrig.wind_at_level(*(torch.as_tensor(a) for a in (u, v, p)),
                              target)
    return tuple(_np(g) == _np(r) for g, r in zip(got, ref))


def _check_step(got_state, got_out, ref_state, ref_out, same):
    """Per-step fields within 2e-5/2e-4 with MISSING structure equal; the
    wind state bit-equal wherever the fresh winds ``same`` agreed bit for
    bit, and within the wind tolerances elsewhere."""
    for key in ref_out:
        _close(got_out[key], ref_out[key], key)
    assert got_state.tt == int(ref_state.tt)
    np.testing.assert_allclose(_np(got_state.thc), _np(ref_state.thc),
                               rtol=1e-6)
    for key, ok, tol in (("windspeed", same[0], dict(rtol=1e-6, atol=0)),
                         ("winddir", same[1], dict(rtol=0, atol=1e-3))):
        g, r = _np(getattr(got_state, key)), _np(getattr(ref_state, key))
        np.testing.assert_array_equal(g[ok], r[ok], err_msg=key)
        np.testing.assert_allclose(g, r, err_msg=key, **tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_ci", [True, False])
def test_prepare_mask_matches_jax(case, with_ci, request, monkeypatch):
    """Sign and sentinel structure equal, then 2e-5/2e-3, against the JAX
    ``prepare_mask``; equal to the batch pipeline's distance field; the
    device tables are built once across calls."""
    from seabreeze_param_tpu_torch.models import pipeline as tpipe
    built = []
    monkeypatch.setattr(tpipe, "device_tables",
                        lambda *a: built.append(a) or tdist.device_tables(*a))
    c = request.getfixturevalue(case)
    jg, tg = _grids(c)
    ci = c["ci_t"][-1] if with_ci else None
    ref = jcoup.CoupledTrigger(grid=jg).prepare_mask(c["lsm"], ci)
    ct = tcoup.CoupledTrigger(grid=tg, device="cpu")
    got = ct.prepare_mask(c["lsm"], ci)
    torch.testing.assert_close(ct.prepare_mask(c["lsm"], ci), got, rtol=0,
                               atol=0)
    assert len(built) == 1
    _cdist_close(got, ref)
    # the batch pipeline's distance field, as in tests/test_coupling.py
    pipe = TriggerPipeline(tg, device="cpu")
    torch.testing.assert_close(
        got, pipe.distance_field(torch.as_tensor(c["lsm"]),
                                 None if ci is None else torch.as_tensor(ci)),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pres_dim", [1, 3])
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_physics_matches_jax(case, pres_dim, tt, request):
    """physics on the JAX mask, 1-D and 3-D pressure, at first-step
    seeding (1), a plain step (5) and a wind refresh (15), as
    :func:`_check_step` holds it.  The port's kernel route (B4's plain
    version on the CPU) equals its plain route bit for bit."""
    c = request.getfixturevalue(case)
    jg, tg = _grids(c)
    jct = jcoup.CoupledTrigger(grid=jg)
    cdist = np.asarray(jct.prepare_mask(c["lsm"], c["ci_t"][0]))
    st, theta, u, v, p = _fields(c, tt, pres_dim=pres_dim)
    ref_state, ref_out = jct.physics(_jstate(tt, st), p, u, v, theta,
                                     c["z"], c["std"], cdist)
    runs = []
    for uk in (None, True):
        ct = tcoup.CoupledTrigger(grid=tg, use_kernels=uk, device="cpu")
        state = state_from_numpy(tt, st["thc"], st["ws"], st["wd"], "cpu")
        got_state, got_out = ct.physics(state, p, u, v, theta, c["z"],
                                        c["std"], cdist)
        np.testing.assert_array_equal(_np(state.windspeed), st["ws"])
        _check_step(got_state, got_out, ref_state, ref_out,
                    _same_wind(u, v, p))
        runs.append((got_state, got_out))
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        torch.testing.assert_close(runs[0][1][key], runs[1][1][key], rtol=0,
                                   atol=0)
    # the last-row quirk: zero outputs, frozen state
    np.testing.assert_array_equal(_np(runs[1][1]["windspeed"])[-1], 0.0)
    np.testing.assert_array_equal(_np(runs[1][0].windspeed)[-1],
                                  st["ws"][-1])


@pytest.mark.parametrize("case", CASES)
def test_sea_breeze_diag_matches_jax(case, request, monkeypatch):
    """The functional UM form: seconds -> minutes, the inout triple
    updated, error 0; equal to the bound physics call and to the JAX
    routine.  It builds no distance tables (the mask comes precomputed)."""
    c = request.getfixturevalue(case)
    jg, tg = _grids(c)
    cdist = np.asarray(jcoup.CoupledTrigger(grid=jg).prepare_mask(
        c["lsm"], c["ci_t"][0]))
    st, theta, u, v, p = _fields(c, 15)
    ref = jcoup.sea_breeze_diag(
        24.0 * 60.0, 15, p, u, v, theta, c["z"], c["std"], cdist, st["ws"],
        st["wd"], st["thc"], jg)

    def no_tables(*a, **k):
        raise AssertionError("sea_breeze_diag built distance tables")

    monkeypatch.setattr(tdist, "device_tables", no_tables)
    got = tcoup.sea_breeze_diag(
        24.0 * 60.0, 15, p, u, v, theta, c["z"], c["std"], cdist, st["ws"],
        st["wd"], st["thc"], tg, device="cpu")
    assert got[4] == ref[4] == tcoup.ERROR_NONE
    _check_step(TriggerState(16, got[3], got[1], got[2]), {"sb_con": got[0]},
                JState(16, ref[3], ref[1], ref[2]), {"sb_con": ref[0]},
                _same_wind(u, v, p))

    ct = tcoup.CoupledTrigger(grid=tg, device="cpu")
    bound_state, bound_out = ct.physics(
        state_from_numpy(15, st["thc"], st["ws"], st["wd"], "cpu"), p, u, v,
        theta, c["z"], c["std"], cdist)
    for a, b in ((got[0], bound_out["sb_con"]),
                 (got[1], bound_state.windspeed),
                 (got[3], bound_state.thc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_error_path():
    """The UM bounds check: an empty vertical axis or horizontal grid gives
    error 1 and the inout fields back untouched."""
    for shape in ((0, 4, 3), (4, 0, 3), (4, 4, 0)):
        assert tcoup.validate_grid(*shape) == tcoup.ERROR_BAD_GRID
        assert jcoup.validate_grid(*shape) == jcoup.ERROR_BAD_GRID
    assert tcoup.validate_grid(4, 4, 3) == tcoup.ERROR_NONE
    assert (tcoup.ERROR_NONE, tcoup.ERROR_BAD_GRID) == (
        jcoup.ERROR_NONE, jcoup.ERROR_BAD_GRID)

    grid = Grid.regular(4, 8, lat0=10.0, lat1=-10.0)
    theta = np.zeros((4, 8), np.float32)
    ws0 = np.full((4, 8), 7.0, np.float32)
    sb, ws, wd, thc, err = tcoup.sea_breeze_diag(
        1440.0, 1, np.zeros((0,), np.float32),
        np.zeros((0, 4, 8), np.float32), np.zeros((0, 4, 8), np.float32),
        theta, theta, theta, theta, ws0, theta, theta, grid, device="cpu")
    assert err == tcoup.ERROR_BAD_GRID
    assert ws is ws0 and thc is theta
    np.testing.assert_array_equal(ws, np.full((4, 8), 7.0, np.float32))


def test_cumulus_mask_matches_jax():
    sb = np.array([[0.0, 0.5, -0.2], [float(MISSING), 2.0, 0.05],
                   [0.1, -float(MISSING), 0.100001]], np.float32)
    for kw in ({}, dict(min_strength=0.1)):
        got = tcoup.cumulus_mask(torch.as_tensor(sb), **kw)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            _np(got), np.asarray(jcoup.cumulus_mask(sb, **kw)))
    np.testing.assert_array_equal(
        _np(tcoup.cumulus_mask(sb[:2])),
        [[False, True, False], [False, True, True]])


@pytest.mark.parametrize("with_ci", [True, False])
def test_pipeline_step_matches_jax(small_case, with_ci):
    """Two threaded steps of ``TriggerPipeline.step`` (distance rebuild +
    trigger) against JAX ``pipe.step``, from tt=14 across the tt=15 wind
    refresh; the kernel route equals the plain route bit for bit."""
    c = small_case
    jg, tg = _grids(c)
    st, *_ = _fields(c, 14, seed=5)
    jst = _jstate(14, st)
    tst = {uk: state_from_numpy(14, st["thc"], st["ws"], st["wd"], "cpu")
           for uk in (None, True)}
    jpipe = JPipe(jg)
    same = (True, True)
    for t in range(2):
        ci = c["ci_t"][t + 1] if with_ci else None
        args = (c["theta_t"][t], c["u_t"][t], c["v_t"][t], c["lsm"], c["z"],
                c["std"], c["p"])
        jst, ref = jpipe.step(jst, *args, ci=ci)
        # a cell's state stays bit-equal while every step's winds agreed
        same = tuple(a & b for a, b in zip(
            same, _same_wind(c["u_t"][t], c["v_t"][t], c["p"])))
        outs = {}
        for uk in tst:
            pipe = TriggerPipeline(tg, device="cpu", use_kernels=uk)
            tst[uk], outs[uk] = pipe.step(tst[uk], *args, ci=ci)
            _check_step(tst[uk], outs[uk], jst, ref, same)
        for key in ref:
            torch.testing.assert_close(outs[None][key], outs[True][key],
                                       rtol=0, atol=0)
    assert tst[None].tt == 16


def test_step_distance_impls_agree(small_case):
    """``distance_impl``: 'fused' and 'hybrid' take their kernels' plain
    versions on the CPU, 'auto' resolves to 'plain' there (and to 'fused'
    on the card, 'hybrid' with the nearest lon form), and the JAX
    package's 'xla' and 'pallas' are 'plain' and 'fused', so all six give
    one distance field; a bad name is refused."""
    c = small_case
    _, tg = _grids(c)
    lsm, ci = (torch.as_tensor(a) for a in (c["lsm"], c["ci_t"][2]))
    impls = tdist.IMPLS + tuple(tdist.IMPL_ALIASES)
    fields = [TriggerPipeline(tg, device="cpu", distance_impl=impl,
                              use_kernels=True).distance_field(lsm, ci)
              for impl in impls]
    for f in fields[1:]:
        torch.testing.assert_close(f, fields[0], rtol=0, atol=0)
    assert tdist.resolve_impl("auto", "cpu") == "plain"
    assert tdist.resolve_impl("auto", "cuda") == "fused"
    assert tdist.resolve_impl("auto", "cuda", "nearest") == "hybrid"
    assert tdist.resolve_impl("xla", "cuda") == "plain"
    assert tdist.resolve_impl("pallas", "cpu") == "fused"
    with pytest.raises(ValueError, match="mosaic"):
        TriggerPipeline(tg, device="cpu",
                        distance_impl="mosaic").distance_field(lsm, ci)


def test_dummy_model_matches_jax():
    """The port's dummy model, 3 steps, against the JAX example at the
    tolerances ``test_torch_pipeline.py::test_diag_matches_jax_diag`` holds
    ``diag`` to; kernel route (plain versions on the CPU) equal to the plain
    route; ``--sharded`` runs (the 1 x 1 mesh of ``'auto'`` on the CPU;
    ``tests/test_torch_sharded.py`` holds it to JAX on 2 x 4)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import dummy_model as jdummy
    jfinal, jsb = jdummy.run(steps=3)
    jsb = np.asarray(jsb)
    final, sb = tdummy.run(steps=3, device="cpu")
    sb = _np(sb)
    assert sb.shape == jsb.shape == (3, tdummy.NY, tdummy.NX)
    assert final.tt == int(jfinal.tt) == 4
    miss = jsb == MISSING
    np.testing.assert_array_equal(sb == MISSING, miss)
    mism = ~np.isclose(sb[~miss], jsb[~miss], rtol=5e-4, atol=5e-4)
    assert mism.mean() < 2e-3, f"{mism.sum()} / {mism.size}"
    np.testing.assert_allclose(_np(final.thc), np.asarray(jfinal.thc),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(final.windspeed),
                               np.asarray(jfinal.windspeed), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_np(final.winddir),
                               np.asarray(jfinal.winddir), rtol=0, atol=1e-3)
    for k in ("land_frac", "z", "sigma", "p", "u", "v", "theta"):
        np.testing.assert_array_equal(tdummy.init_fields()[k],
                                      jdummy.init_fields()[k])

    kfinal, ksb = tdummy.run(steps=3, device="cpu", use_kernels=True)
    torch.testing.assert_close(ksb, torch.as_tensor(sb), rtol=0, atol=0)
    torch.testing.assert_close(kfinal.windspeed, final.windspeed, rtol=0,
                               atol=0)
    sfinal, ssb = tdummy.run(steps=1, sharded=True, device="cpu")
    assert ssb.shape == (1, tdummy.NY, tdummy.NX) and sfinal.tt == 2
    assert torch.isfinite(ssb).all()


def test_dummy_model_main_prints(capsys):
    tdummy.main(["--steps=2", "--device=cpu"])
    out = capsys.readouterr().out
    assert "2 coupled steps on 96x128 (cpu)" in out and "tt=3" in out
    with pytest.raises(SystemExit):
        tdummy.main(["--bogus"])


# -- tracing -----------------------------------------------------------------
def test_tracer_records_and_reports():
    tr = Tracer(enabled=True)
    with tr.hook("outer"):
        with tr.hook("inner"):
            sum(range(1000))
        tr.count("h2d_bytes", 4096)
    tr.count("h2d_bytes", 1024)
    rep = tr.report()
    assert "outer" in rep and "inner" in rep
    assert tr.records["outer"].calls == 1
    assert tr.records["outer"].child_s <= tr.records["outer"].total_s
    assert tr.records["outer"].self_s >= 0
    # the counters' lines follow the routines'; no device column here
    lines = rep.splitlines()
    assert lines[0].split() == ["routine", "calls", "total_s", "self_s"]
    assert lines[-2].split() == ["counter", "value"]
    assert lines[-1].split() == ["h2d_bytes", "5120"]
    tr.reset()
    assert not tr.records and not tr.counters


def test_tracer_disabled_is_passthrough():
    tr = Tracer(enabled=False)
    with tr.hook("x"):
        pass
    assert not tr.records


def test_coupling_hooks_reach_tracer_and_profiler(small_case):
    """CoupledTrigger traces every phase: host timings in an enabled
    tracer, and the named ranges in a profile."""
    c = small_case
    _, tg = _grids(c)
    tr = Tracer(enabled=True)
    ct = tcoup.CoupledTrigger(grid=tg, tracer=tr, device="cpu")
    st, theta, u, v, p = _fields(c, 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cd = ct.prepare_mask(c["lsm"], c["ci_t"][0])
        ct.physics(TriggerState.zeros(cd.shape, "cpu"), p, u, v, theta,
                   c["z"], c["std"], cd)
    labels = ("coupling:get_edges", "coupling:get_dist",
              "coupling:seabreeze_diag")
    assert all(tr.records[k].calls == 1 for k in labels)
    names = {e.key for e in prof.key_averages()}
    assert set(labels) <= names


def test_device_info():
    info = device_info()
    assert info["platform"] == "cpu" and info["device_kind"] == "cpu"
    assert info["num_devices"] == info["num_local_devices"] == 1
    assert info["num_hosts"] == 1
