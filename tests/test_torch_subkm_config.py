"""The UM London Model's 333 m deployment (``portbench/configs/
um_london_333m.json``, the cell ``um_london_333m.diag_noice``): the port's
``api.diag`` against the benchmark's plain reference on a cut of it at the
same 0.003 deg spacing, where the distance's radius k = 462 and the ring
radius NN >= 466 (the probe's whole-domain frame and the ring search's
large builds on the card); the probe's span ``probe:transform`` and its
counter ``probe_frame_cells``; and the per-layer metrics the cell reports,
with the readers this configuration added or extended to it."""
import time
import types

import numpy as np
import pytest
import torch

from portbench import compare, harness, world
from portbench.reference import trigger as ref
from portbench.trace import Window
from seabreeze_param_tpu.ops.ring_search import required_ring_radius_host
from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.ring_search import (ring_bound,
                                                        static_ring_bound)
from seabreeze_param_tpu_torch.utils import tracing

CELL = "um_london_333m.diag_noice"
CONFIG = harness.load_json(harness.HERE / "configs" / "um_london_333m.json")
LIMITS = harness.load_json(harness.HERE / "workloads"
                           / f"{CELL}.json")["limits"]
DX = 0.003
#: The cut: 64 x 512 cells of the configuration's grid from its corner.
CUT_H, CUT_W, CUT_T = 64, 512, 4
CUT_LEVELS = (500.0, 700.0, 850.0, 1000.0)


def _grid(nlat, nlon):
    return world.grid(dict(CONFIG["grid"], nlat=nlat, nlon=nlon,
                           lat1=CONFIG["grid"]["lat0"] - (nlat - 1) * DX,
                           lon1=CONFIG["grid"]["lon0"] + nlon * DX))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain path's many small ops at k = 462
    run ~4x faster on one thread than on eight, and far faster beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def quiet_tracer():
    """The process-global tracer off and empty before and after."""
    tracing.tracer.reset()
    api.clear_exec_cache()
    yield tracing.tracer
    tracing.tracer.enabled = False
    tracing.tracer.reset()
    api.clear_exec_cache()


def test_config_grid_is_0p003_deg_and_k_462():
    lon, lat = world.grid(CONFIG["grid"])
    assert len(lat) == len(lon) == 1024
    np.testing.assert_allclose(np.diff(lat), -DX, atol=5e-6)
    np.testing.assert_allclose(np.diff(lon), DX, atol=5e-6)
    k = ref.search_radius(lon, lat, CONFIG["params"]["maxdist"])
    assert k == CONFIG["derived"]["k"] == 462
    assert ref.search_radius(*_grid(CUT_H, CUT_W),
                             CONFIG["params"]["maxdist"]) == 462
    assert [float(p) for p in CONFIG["pres_hpa"]] == [
        float(p) for p in harness.load_json(
            harness.HERE / "configs" / "era5_025.json")["pres_hpa"]]


def test_cut_diag_matches_reference(quiet_tracer, monkeypatch):
    """A 64 x 512 cut, 4 steps, 4 levels, no sea ice, from a seed: the
    port's ``api.diag`` (the plain path here; the large builds on the card)
    against the plain reference, judged at the cell's limits, with the
    probe's span and counters recorded under the enabled tracer."""
    lon, lat = _grid(CUT_H, CUT_W)
    cpu = torch.device("cpu")
    g = world.generator(2**31 + 2**20 + 3, cpu)
    lsm, z, std = world.make_world(CUT_H, CUT_W, g, cpu)
    pres = 100.0 * torch.tensor(CUT_LEVELS)
    theta = world.noise((CUT_T, CUT_H, CUT_W), 5.0, 288.0, g, cpu)
    u, v = (world.noise((CUT_T, len(CUT_LEVELS), CUT_H, CUT_W), 6.0, 0.0,
                        g, cpu) for _ in range(2))
    params = CONFIG["params"]
    seen, real = [], TriggerPipeline.run

    def run(self, *args, nn=None, **kwargs):
        seen.append(nn)
        return real(self, *args, nn=nn, **kwargs)
    monkeypatch.setattr(TriggerPipeline, "run", run)
    quiet_tracer.enabled = True
    tt, sb, thc, ws, wd = api.diag(
        1, lsm.numpy(), z.numpy(), std.numpy(), lon, lat, pres.numpy(),
        u.numpy(), v.numpy(), theta.numpy(), None, device="cpu", **params)
    quiet_tracer.enabled = False
    assert tt == 1 + CUT_T and sb.shape == (CUT_T, CUT_H, CUT_W)

    settings = ref.Settings(**params)
    st = ref.State(1, *(torch.zeros_like(lsm) for _ in range(3)))
    st, sb_ref, work = ref.diag(st, lsm, z, std, lon, lat, pres, u, v,
                                theta, None, settings)
    assert work["k"] == 462
    judge = compare.Judge(LIMITS)
    judge.judge(sb, sb_ref, {"t0": thc, "windspeed": ws, "winddir": wd},
                {"t0": st.thc, "windspeed": st.windspeed,
                 "winddir": st.winddir})
    assert judge.failed == 0, judge.worst
    assert judge.worst["sb_missing_flips"] == 0
    # every cell of the cut lies within maxdist of a coast
    assert bool((np.abs(sb) < 1e20).all())

    # the call ran at NN >= k + 2 + margin = 466: the large builds' range
    [nn] = seen
    assert 466 <= nn <= 2047
    assert nn >= max(int(r.max()) for r in work["radii"])
    # one pass of the probe, its cap the whole domain (min(512, 4k))
    assert quiet_tracer.records["probe:transform"].calls == 1
    assert quiet_tracer.counters["probe_frame_cells"] == (
        (CUT_H + 2 * CUT_W) * (CUT_W + 2 * CUT_W))


def _far_sea(nlat=10, nlon=100):
    """Land everywhere but one sea column: the ring radius of the cells
    farthest from it passes the probe's first caps, so the probe doubles
    its frame."""
    cdist = np.ones((nlat, nlon), np.float32)
    cdist[:, 0] = -1.0
    return cdist


def _frames(nlat, nlon, caps):
    return sum((nlat + 2 * c) * (nlon + 2 * c) for c in caps)


def test_probe_span_and_frame_counter_each_pass(quiet_tracer):
    cdist = _far_sea()
    params = Params()
    quiet_tracer.enabled = True
    got = ring_bound(cdist, 1, params)
    quiet_tracer.enabled = False
    # caps 8, 16, 32, 64: the first result below its cap ends the passes
    probed = required_ring_radius_host(
        cdist, params.maxdist, exact_lon=params.exact_lon_indexing)
    assert got == max(static_ring_bound(1, params),
                      probed + params.ring_search_margin)
    assert 32 <= probed < 64 and got == probed + params.ring_search_margin
    assert quiet_tracer.records["probe:transform"].calls == 4
    assert quiet_tracer.counters["probe_frame_cells"] == _frames(
        10, 100, (8, 16, 32, 64))


def test_probe_span_and_counters_under_a_profiler(quiet_tracer):
    cdist = _far_sea()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ring_bound(cdist, 1, Params())
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("probe:transform") == 4
    assert quiet_tracer.counters["probe_frame_cells"] == _frames(
        10, 100, (8, 16, 32, 64))


def _small_diag():
    """One two-step ``api.diag`` call on a 12 x 16 corner of the grid, its
    east half land, one pressure level."""
    lon, lat = _grid(12, 16)
    lsm = np.zeros((12, 16), np.float32)
    lsm[:, 9:] = 1.0
    zeros = np.zeros((2, 1, 12, 16), np.float32)
    api.diag(1, lsm, lsm, lsm, lon, lat, np.array([70000.0], np.float32),
             zeros, zeros, zeros[:, 0] + 288.0, None, device="cpu")


def test_probe_span_and_counters_off_without_a_reader(quiet_tracer,
                                                      monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert quiet_tracer.hook("probe:transform") is tracing._OFF
    ring_bound(_far_sea(), 1, Params())
    _small_diag()
    assert entered == []
    assert not quiet_tracer.counters and not quiet_tracer.records


#: The per-layer metrics a traced run of the cell reports: every diag
#: metric of ``era5_025.diag_ice`` but B3's roofline (its all-taps bound
#: sits too close under the large build's time to stay below 100%), and
#: the probe's two, and the bytes through the staging slots.
CELL_METRICS = {
    "copy_ms_per_step.diag": True, "launches_per_step.diag": True,
    "torch_ops_ms_per_step.diag": True, "ring_roofline.diag": True,
    "distance_roofline.diag": False, "device_idle_share.diag": True,
    "probe_ms_per_step.diag": True, "h2d_mb_per_step.diag": True,
    "host_waits_per_step.diag": True, "program_idle_share.diag": True,
    "probe_transform_ms_per_step.diag": True,
    "probe_frame_mcells_per_step.diag": True,
    "staged_mb_per_step.diag": True,
}


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_cell_reports_the_diag_metrics(name):
    names = {m["name"] for m in harness.cell_metrics(CELL, True)}
    assert (name in names) is CELL_METRICS[name]
    assert names <= set(CELL_METRICS)


#: A synthetic traced window (us): B1's large build and a PyTorch kernel
#: on the device; two calls' probe spans on the host, one cut at the end.
SPAN = (1000.0, 2000.0)
DEVICE = [("void (anonymous namespace)::land_rows(float const*)", 1100.0,
           1150.0),
          ("void (anonymous namespace)::land_cols(int*)", 1150.0, 1200.0),
          ("void (anonymous namespace)::ring_kernel<1, 0, 0>(Args)",
           1200.0, 1600.0),
          ("void at::native::elementwise_kernel<128, 2>", 1600.0, 1700.0)]
HOST = [("api:probe", 1010.0, 1300.0), ("probe:transform", 1050.0, 1250.0),
        ("api:probe", 1900.0, 2100.0), ("probe:transform", 1950.0, 2050.0)]
STEPS = 48
B1_WORK = (3.35e6, 6.7e9)             # 1 us of bytes, 100 us of additions


def _run(trace=True, device=DEVICE, host=HOST, work=None):
    win = Window(trace=trace, cuda=True)
    win.span, win.device, win.host = SPAN, list(device), list(host)
    return types.SimpleNamespace(window=win, steps=STEPS,
                                 work={"b1": B1_WORK} if work is None
                                 else work)


@pytest.fixture
def port_counters(monkeypatch):
    """The port's tracer counters as a traced run leaves them."""
    monkeypatch.setitem(tracing.tracer.counters, "probe_frame_cells",
                        2 * 9_437_184)
    return tracing.tracer.counters


READERS = {
    # 200 us and the 50 us inside the window, over 48 steps
    "probe_transform_ms_per_step.diag": 0.250 / STEPS,
    # two passes at cap 1024 on the 1024 x 1024 grid
    "probe_frame_mcells_per_step.diag": 2 * 9.437184 / STEPS,
    # 100 us of additions over 500 us of B1's three kernels
    "ring_roofline.diag": 20.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_reader_reads_a_recorded_run(name, port_counters):
    entry = next(m for m in harness.spec()["per_layer"]
                 if m["name"] == name)
    assert CELL in entry["workloads"]
    assert entry["moves"] == "diag_ms_per_step"
    got = harness.load_module("metrics", name).read(_run())
    assert got == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_reader_is_none_untraced(name, port_counters):
    read = harness.load_module("metrics", name).read
    assert read(_run(trace=False)) is None
    assert read(_run(device=[])) is None


def test_new_readers_find_nothing_in_a_parent(monkeypatch):
    """A program without the span, the counter or B1's kernels (the
    parent, or a window that ran no ring kernel) reads None, not 0."""
    monkeypatch.delitem(tracing.tracer.counters, "probe_frame_cells",
                        raising=False)
    load = harness.load_module
    bare = _run(host=[("api:probe", 1010.0, 1300.0)])
    assert load("metrics", "probe_transform_ms_per_step.diag").read(
        bare) is None
    assert load("metrics", "probe_frame_mcells_per_step.diag").read(
        bare) is None
    assert load("metrics", "ring_roofline.diag").read(
        _run(device=DEVICE[3:])) is None
    assert load("metrics", "ring_roofline.diag").read(
        _run(work={})) is None


def test_cell_runs_its_path_at_a_tiny_size():
    """The cell's own files through its path, at a 40 x 64 corner of its
    grid (k capped at 64 there), no sea ice: correct, and its end-to-end
    metrics read."""
    lon, lat = _grid(40, 64)
    tiny = dict(CONFIG["grid"], nlat=40, nlon=64, lat1=float(lat[-1]),
                lon1=CONFIG["grid"]["lon0"] + 64 * DX)
    ctx = harness.context(CELL, 2**32 + 9, 0.2, False, "cpu",
                          time.perf_counter(), overrides={"grid": tiny})
    assert ctx.workload["ice"] == "none"
    result, _ = harness.run_cell(ctx)
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "diag_ms_per_step"}
