"""The port's batch driver (``cli/run.py``), checkpoint, resilience,
metrics and composites against the JAX package's on the CPU; mirrors the
driver tests of ``tests/test_io.py`` and the checkpoint, resilience,
metrics and composites tests of ``tests/test_aux_subsystems.py``.

Both drivers run on one synthetic tree written by the port's writer
(``tests/test_torch_io.py::build_tree``).  The JAX package reads it
through scipy: its native reader drops the index of ``Meta``'s rank
fallback on classic files (see ``tests/test_torch_io.py``).  Outputs of a
run are read and removed before the next, since every run writes the same
``{prefix}sb_{date}.nc`` files into the tree.
"""
import io
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.cli import composites as jcomp
from seabreeze_param_tpu.cli import run as jrun
from seabreeze_param_tpu.ops import trigger as jtrig
from seabreeze_param_tpu_torch import api as tapi
from seabreeze_param_tpu_torch import io as tio
from seabreeze_param_tpu_torch.cli import composites as tcomp
from seabreeze_param_tpu_torch.cli import run as trun
from seabreeze_param_tpu_torch.core import checkpoint as tckpt
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.io import native_nc as tnative
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops import trigger as ttrig
from seabreeze_param_tpu_torch.utils import metrics as tmetrics
from seabreeze_param_tpu_torch.utils import resilience as tres
from tests.test_torch_coupling import _close
from tests.test_torch_io import ROOT, _jax_native_off, build_tree, write_conf
from tests.test_torch_sharded import _assert_outputs_close

F = np.float32


def _outputs(written):
    """sb_con, thc and time of each written file, which is then removed."""
    out = []
    for path in written:
        with tio.Dataset(path) as f:
            out.append({k: np.ma.getdata(f.variables[k][:])
                        for k in ("sb_con", "thc", "time")})
        os.remove(path)
    return out


def run_port(conf, **kw):
    """The port's driver on the CPU: ``((tt, thc, ws, wd), outputs)``."""
    *state, written = trun.main(str(conf), progress=None, device="cpu", **kw)
    return tuple(state), _outputs(written)


def run_jax(conf, **kw):
    with _jax_native_off():
        *state, written = jrun.main(str(conf), progress=None, **kw)
    return tuple(state), _outputs(written)


def _files_equal(oa, ob):
    assert len(oa) == len(ob)
    for fa, fb in zip(oa, ob):
        for key in fb:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def _bit_equal(a, b):
    """Two runs' final states and written files, bit for bit."""
    (sa, oa), (sb, ob) = a, b
    assert sa[0] == sb[0]
    for x, y in zip(sa[1:], sb[1:]):
        np.testing.assert_array_equal(x, y)
    _files_equal(oa, ob)


def _same_wind_series(tree):
    """Where both packages' fresh winds agreed bit for bit on every step of
    the series: there the final wind state is bit-equal (ROADMAP queue 3)."""
    target = Params().target_plev_pa
    # jitted, as in the JAX scan: eager dispatch contracts no FMA
    jwind = jax.jit(jtrig.wind_at_level, static_argnums=3)
    same = [True, True]
    for day in tree["series"]:
        for u, v in zip(day["u"], day["v"]):
            ref = jwind(u, v, tree["pres"], target)
            got = ttrig.wind_at_level(torch.as_tensor(u), torch.as_tensor(v),
                                      torch.as_tensor(tree["pres"]), target)
            same = [s & (g.numpy() == np.asarray(r))
                    for s, g, r in zip(same, got, ref)]
    return same


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(tmp_path_factory.mktemp("driver_tree"))


@pytest.fixture(scope="module")
def tree3(tmp_path_factory):
    """Three days, sea ice from day 2 on: for resume and composites."""
    return build_tree(tmp_path_factory.mktemp("driver_tree3"), ndays=3,
                      ice=True)


# -- the driver against the JAX driver ----------------------------------------
def test_driver_matches_jax(tree, tmp_path):
    """24 x 32, 2 files x 4 steps.  Written sb_con and thc: MISSING
    structure equal, then rtol 2e-5 / atol 2e-4; tt equal; final thc rtol
    1e-6; final ws/wd bit-equal where the fresh winds agreed, else rtol
    1e-6 (speed) and atol 1e-3 deg (direction); the metrics lines carry
    the same keys."""
    mj, mt = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    ref = run_jax(tree["conf"], metrics_file=str(mj))
    got = run_port(tree["conf"], metrics_file=str(mt))
    (rs, ro), (gs, go) = ref, got
    assert gs[0] == rs[0] == 1 + 2 * 4
    assert len(go) == len(ro) == 2
    for g, r in zip(go, ro):
        np.testing.assert_array_equal(g["time"], r["time"])
        for key in ("sb_con", "thc"):
            assert g[key].shape == (4, 24, 32)
            _close(g[key], r[key], key)
        assert (g["sb_con"] == tio.MISSING).any()
    np.testing.assert_allclose(gs[1], rs[1], rtol=1e-6)
    same = _same_wind_series(tree)
    for i, ok, tol in ((2, same[0], dict(rtol=1e-6, atol=0)),
                       (3, same[1], dict(rtol=0, atol=1e-3))):
        np.testing.assert_array_equal(gs[i][ok], rs[i][ok])
        np.testing.assert_allclose(gs[i], rs[i], **tol)
    lines = [[json.loads(ln) for ln in m.read_text().splitlines()]
             for m in (mj, mt)]
    assert len(lines[0]) == len(lines[1]) == 2
    for lj, lt in zip(*lines):
        assert lj.keys() == lt.keys()
    assert lines[1][-1]["steps"] == 8 and lines[1][-1]["points_per_s"] > 0


def test_driver_reuses_cached_pipelines(tree, tmp_path):
    """``tests/test_io.py::test_batch_driver_reuses_cached_executable``:
    after the first file every pipeline lookup hits (the sticky ring bound
    keeps the second file on the same pipelines), and a whole rerun builds
    nothing."""
    tapi.clear_exec_cache()
    mfile = tmp_path / "m.jsonl"
    run_port(tree["conf"], metrics_file=str(mfile))
    lines = [json.loads(ln) for ln in mfile.read_text().splitlines()]
    assert lines[0]["exec_cache_misses"] == lines[1]["exec_cache_misses"]
    assert lines[1]["exec_cache_hits"] >= 2             # base + ring, file 2
    misses = tapi.CACHE_STATS["pipeline_misses"]
    run_port(tree["conf"])
    assert tapi.CACHE_STATS["pipeline_misses"] == misses


def test_driver_scipy_reading_equals_native(tree, monkeypatch):
    """With the native reader off every input comes through scipy as
    big-endian arrays; the run is bit-equal to the native reader's."""
    native = run_port(tree["conf"])
    monkeypatch.setattr(tnative, "available", lambda: False)
    _bit_equal(run_port(tree["conf"]), native)


def test_driver_mesh_matches_single_and_jax(tmp_path_factory):
    """``--mesh=2x2`` on 160 x 288, nt = 2 (``tests/test_io.py``'s sharded
    driver test) against the single device and the JAX driver's
    ``--mesh=2x2``: outputs by the sharded tolerance (MISSING equal, rtol
    1e-5 / atol 1e-4 with under 1e-3 of cells off), thc rtol 1e-6 / atol
    1e-5, ws rtol 1e-5 / atol 1e-4."""
    s = build_tree(tmp_path_factory.mktemp("driver_mesh"), nlat=160,
                   nlon=288, nt=2)
    single = run_port(s["conf"])
    meshed = run_port(s["conf"], mesh="2x2")
    ref = run_jax(s["conf"], mesh="2x2")
    for other in (single, ref):
        assert meshed[0][0] == other[0][0] == 1 + 2 * 2
        np.testing.assert_allclose(meshed[0][1], other[0][1], rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(meshed[0][2], other[0][2], rtol=1e-5,
                                   atol=1e-4)
        for g, r in zip(meshed[1], other[1]):
            _assert_outputs_close({k: g[k] for k in ("sb_con", "thc")},
                                  {k: r[k] for k in ("sb_con", "thc")})


def test_driver_resume_is_bit_equal(tree3, tmp_path, monkeypatch):
    """A run that stops after day 2 under ``ckpt_dir``, then the full
    series on the same directory: final state and the day-3 file bit-equal
    to an unbroken run; a third run recomputes nothing and returns the
    same state."""
    unbroken = run_port(tree3["conf"])
    ck = str(tmp_path / "ck")
    first = run_port(write_conf(tree3, 3), ckpt_dir=ck)
    assert len(first[1]) == 2 and first[0][0] == 1 + 2 * 4
    resumed = run_port(tree3["conf"], ckpt_dir=ck)
    assert len(resumed[1]) == 1                   # day 3 only
    _bit_equal(resumed, (unbroken[0], unbroken[1][2:]))
    _files_equal(first[1], unbroken[1][:2])
    calls = []
    orig = tapi.diag
    monkeypatch.setattr(tapi, "diag",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    again = run_port(tree3["conf"], ckpt_dir=ck)
    assert calls == []
    _bit_equal(again, (unbroken[0], []))
    assert tckpt.latest_step(ck) == 1 + 3 * 4


def test_driver_refuses_multi_process(tree, monkeypatch):
    """A multi-process launch (WORLD_SIZE > 1) that lacks the rest of the
    launcher's variables is refused before any file is read, naming them:
    each process would otherwise run the whole series alone.  The
    multi-process run itself: ``tests/test_torch_multihost.py``."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    for var in ("RANK", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="without RANK, MASTER_PORT"):
        trun.main(str(tree["conf"]), progress=None, device="cpu")


def test_driver_runs_without_h5py_or_jax(tree):
    """The card's machine has no h5py and no JAX: the driver, the
    composites and their modules import and run with jax, orbax, h5py,
    matplotlib and the JAX package blocked."""
    code = f"""
import sys
for name in ('jax', 'orbax', 'h5py', 'matplotlib', 'seabreeze_param_tpu'):
    sys.modules[name] = None
from seabreeze_param_tpu_torch.cli import composites, run
tt, thc, ws, wd, written = run.main({str(tree['conf'])!r}, progress=None,
                                    device='cpu')
assert tt == 9 and len(written) == 2, (tt, written)
import os
for p in written:
    os.remove(p)
print('ok')
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_parses_options(tree, monkeypatch):
    """``cli`` passes ``--key=value`` pairs to ``main`` with the JAX
    driver's coercions; ``--help`` exits with the usage text."""
    seen = {}
    monkeypatch.setattr(trun, "main", lambda **kw: seen.update(kw))
    trun.cli([f"--config={tree['conf']}", "--device=cpu",
              "--use_kernels=false", "--maxdist=250", "--mesh=2x2"])
    assert seen == dict(config=str(tree["conf"]), device="cpu",
                        use_kernels=False, maxdist=250.0, mesh="2x2")
    with pytest.raises(SystemExit, match="Usage"):
        trun.cli(["--help=1"])


# -- composites ----------------------------------------------------------------
def test_composites_match_jax(tree3, tmp_path):
    """``diurnal_mean`` and ``seasonal_composites`` on the port driver's
    output equal the JAX package's; ``main`` writes the composite file and
    the four seasonal maps."""
    trun.main(str(tree3["conf"]), progress=None, device="cpu")
    meta = tio.Meta(tio.Config(tree3["conf"]))
    try:
        sb = meta.input_path("sb", tree3["days"][0])
        for var in ("sb_con", "thc"):
            np.testing.assert_array_equal(tcomp.diurnal_mean(sb, var),
                                          jcomp.diurnal_mean(sb, var))
        got = tcomp.seasonal_composites(meta, tio.Config(tree3["conf"]),
                                        progress=None)
        with _jax_native_off():
            jmeta = jcomp.Meta(jcomp.Config(tree3["conf"]))
            ref = jcomp.seasonal_composites(jmeta, jcomp.Config(
                tree3["conf"]), progress=None)
        assert got[1:] == ref[1:] == ({"DJF": 4, "MAM": 1, "JJA": 1,
                                       "SON": 1}, 4)
        for var in ref[0]:
            for season in ref[0][var]:
                np.testing.assert_array_equal(got[0][var][season],
                                              ref[0][var][season])
        ncout, maps = tcomp.main(str(tree3["conf"]),
                                 outdir=str(tmp_path / "maps"),
                                 progress=None)
        with tio.Dataset(ncout) as f:
            assert set(f.variables) >= {"sb_con", "thc", "temp"}
            comp = np.ma.getdata(f.variables["sb_con"][:])
        assert comp.shape == (16, 24, 32)
        np.testing.assert_array_equal(
            comp[:4], (got[0]["sb_con"]["DJF"] / 4).astype(F))
        assert len(maps) == 4 and all(os.path.getsize(p) > 1000
                                      for p in maps)
        os.remove(ncout)
    finally:
        for tag in tree3["days"]:
            os.remove(meta.input_path("sb", tag))


# -- checkpoint, resilience, metrics --------------------------------------------
def _mk_state(shape, tt=1):
    return TriggerState(tt=tt, thc=np.zeros(shape, F),
                        windspeed=np.zeros(shape, F),
                        winddir=np.zeros(shape, F))


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_aux_subsystems.py::test_checkpoint_roundtrip``, plus
    tensors and big-endian arrays in, orbax's skip of a step no newer than
    the latest, and ``max_to_keep``."""
    ckdir = str(tmp_path / "ck")
    assert tckpt.latest_step(ckdir) is None
    assert tckpt.restore_state(ckdir) == (None, None)
    rng = np.random.default_rng(0)
    st = TriggerState(tt=7, thc=rng.random((8, 16)).astype(">f4"),
                      windspeed=torch.rand(8, 16),
                      winddir=rng.random((8, 16)).astype(F))
    assert tckpt.save_state(ckdir, st, extra={"sb_con": np.ones((8, 16), F),
                                              "next_unit": 3}) == 7
    assert tckpt.latest_step(ckdir) == 7
    back, extra = tckpt.restore_state(ckdir)
    assert back.tt == 7
    np.testing.assert_array_equal(back.thc, st.thc)
    np.testing.assert_array_equal(back.windspeed, st.windspeed.numpy())
    np.testing.assert_array_equal(extra["sb_con"], np.ones((8, 16), F))
    assert int(extra["next_unit"]) == 3
    assert tckpt.save_state(ckdir, _mk_state((8, 16), tt=7)) == 7
    np.testing.assert_array_equal(tckpt.restore_state(ckdir)[0].thc, st.thc)
    for tt in (8, 9, 10):
        tckpt.save_state(ckdir, _mk_state((8, 16), tt=tt))
    assert sorted(os.listdir(ckdir)) == ["10", "8", "9"]
    assert tckpt.restore_state(ckdir, step=8)[0].tt == 8


def test_checkpoint_resume_continues_run(tmp_path):
    """Save mid-run, restore, continue: the final state equals the
    unbroken run bit for bit."""
    nlat, nlon, nlev, nt = 24, 32, 3, 6
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:nlat, 0:nlon]
    lsm = ((x > nlon // 2).astype(F) * (0.7 + 0.3 * rng.random((nlat, nlon))))
    z, std = 300.0 * lsm, (80.0 * lsm).astype(F)
    pres = np.array([100000.0, 70000.0, 50000.0], F)
    th = (288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon))).astype(F)
    uu = (5.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    vv = (5.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    pipe = TriggerPipeline(Grid.regular(nlat, nlon, lat0=30.0, lat1=-30.0),
                           device="cpu")
    zeros = TriggerState.zeros((nlat, nlon), "cpu")
    full, _ = pipe.run(zeros, th, uu, vv, lsm, z, std, pres)
    mid, _ = pipe.run(zeros, th[:3], uu[:3], vv[:3], lsm, z, std, pres)
    tckpt.save_state(str(tmp_path / "ck"), mid)
    res, _ = tckpt.restore_state(str(tmp_path / "ck"))
    fin, _ = pipe.run(res, th[3:], uu[3:], vv[3:], lsm, z, std, pres)
    assert fin.tt == full.tt == 7
    for f in ("thc", "windspeed", "winddir"):
        torch.testing.assert_close(getattr(fin, f), getattr(full, f), rtol=0,
                                   atol=0)


def _step(state, unit):
    return TriggerState(tt=state.tt + 1, thc=state.thc + F(unit),
                        windspeed=state.windspeed + F(2 * unit),
                        winddir=state.winddir)


def test_run_resilient_recovers_from_failures(tmp_path):
    units = [1.0, 2.0, 3.0, 4.0]
    ref = _mk_state((4, 6))
    for u in units:
        ref = _step(ref, u)
    fails = {"left": 2}

    def flaky(state, unit):
        if unit == 3.0 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("transient backend failure")
        return _step(state, unit)

    final, done = tres.run_resilient(units, flaky, _mk_state((4, 6)),
                                     str(tmp_path / "ck"), save_every=1,
                                     max_retries=3)
    assert done == len(units) and fails["left"] == 0
    assert int(final.tt) == int(ref.tt)
    np.testing.assert_array_equal(final.thc, ref.thc)
    np.testing.assert_array_equal(final.windspeed, ref.windspeed)


def test_run_resilient_resumes_across_processes(tmp_path):
    seen = []

    def step(state, unit):
        seen.append(unit)
        if unit == "c":
            raise KeyboardInterrupt          # simulated preemption
        return _step(state, 1.0)

    units = ["a", "b", "c", "d"]
    with pytest.raises(KeyboardInterrupt):
        tres.run_resilient(units, step, _mk_state((3, 3)),
                           str(tmp_path / "ck"), save_every=1, max_retries=0)
    assert seen == ["a", "b", "c"]

    def step2(state, unit):
        seen.append(("2", unit))
        return _step(state, 1.0)

    final, done = tres.run_resilient(units, step2, _mk_state((3, 3)),
                                     str(tmp_path / "ck"))
    assert done == len(units)
    assert [x[1] for x in seen if isinstance(x, tuple)] == ["c", "d"]
    assert int(final.tt) == 5
    np.testing.assert_array_equal(final.thc, np.full((3, 3), 4.0, F))


def test_run_resilient_watchdog_aborts_stalled_unit(tmp_path):
    attempts = []

    def step(state, unit):
        attempts.append(unit)
        if unit == "b" and attempts.count("b") == 1:
            for _ in range(100):             # Python-level sleeps, so the
                time.sleep(0.05)             # async exception can land
            raise AssertionError("watchdog never fired")
        return _step(state, 1.0)

    final, done = tres.run_resilient(["a", "b", "c"], step,
                                     _mk_state((3, 3)), str(tmp_path / "ck"),
                                     save_every=1, max_retries=2,
                                     watchdog_deadline_s=0.4)
    assert done == 3 and attempts.count("b") == 2
    assert int(final.tt) == 4
    np.testing.assert_array_equal(final.thc, np.full((3, 3), 3.0, F))


def test_watchdog_detects_stall():
    stalls = []
    with tres.Watchdog(deadline_s=0.15, on_stall=stalls.append,
                       poll_s=0.03) as wd:
        wd.beat()
        time.sleep(0.35)
        assert wd.stall_count == 1
        wd.beat()
        time.sleep(0.35)
        assert wd.stall_count == 2
    assert len(stalls) == 2 and stalls[0] >= 0.15


def test_step_metrics_and_memory_stats():
    """The JAX package's JSON keys; no card, no memory stats."""
    from seabreeze_param_tpu.utils.metrics import StepMetrics as JMetrics
    lines = []
    for cls in (tmetrics.StepMetrics, JMetrics):
        buf = io.StringIO()
        m = cls(grid_points=1000, stream=buf)
        for _ in range(3):
            with m.step():
                sum(range(10000))
        m.add(halo_bytes=42)
        m.emit()
        lines.append(json.loads(buf.getvalue()))
    assert lines[0].keys() == lines[1].keys()
    assert lines[0]["steps"] == 3 and lines[0]["points_per_s"] > 0
    assert lines[0]["halo_bytes"] == 42
    assert tmetrics.device_memory_stats() == {}
