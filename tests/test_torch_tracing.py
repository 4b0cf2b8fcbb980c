"""The port's spans and counters (``utils/tracing.py``): their names and
nesting on the two paths the benchmark drives (``api.diag`` and the
coupled step), the ``wait:`` sites a step passes, the ``h2d_bytes``
counter, and that nothing is recorded, and no profiler range entered,
while no profiler runs and the tracer is off.

Imports neither JAX nor the JAX package, so that the card's test at the
end runs on the card (``python -m pytest tests/test_torch_tracing.py
--noconftest -q``)."""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.coupling import CoupledTrigger
from seabreeze_param_tpu_torch.utils import tracing

PROGRAM = ("api:", "pipeline:", "trigger:", "coupling:", "wait:")
NLAT, NLON, NLEV, T = 48, 64, 4, 2
F4 = np.dtype(np.float32).itemsize


@pytest.fixture
def world():
    lsm, z, std, pres, theta, u, v, ci = make_world(NLAT, NLON, NLEV, T,
                                                    seed=5)
    ci[1, :6] = 0.9                      # the coastline moves at step 1
    lat = np.linspace(60.0, 36.5, NLAT).astype(np.float32)
    lon = np.linspace(-10.0, 22.0, NLON, endpoint=False).astype(np.float32)
    return dict(lsm=lsm, z=z, std=std, pres=pres, theta=theta, u=u, v=v,
                ci=ci, lat=lat, lon=lon)


@pytest.fixture(autouse=True)
def quiet_tracer():
    """The process-global tracer with no counts before and after."""
    tracing.tracer.reset()
    api.clear_exec_cache()
    yield tracing.tracer
    tracing.tracer.reset()
    api.clear_exec_cache()


def _diag(w, **kw):
    return api.diag(1, w["lsm"], w["z"], w["std"], w["lon"], w["lat"],
                    w["pres"], w["u"], w["v"], w["theta"], w["ci"],
                    device="cpu", **kw)


def _coupled(w):
    """A bound coupling on the world's grid, and one step of it: the
    mask, then ``physics`` with host arrays."""
    ct = CoupledTrigger(grid=Grid(lon=w["lon"], lat=w["lat"]),
                        device="cpu")

    def step():
        mask = ct.prepare_mask(w["lsm"], w["ci"][0])
        zero = np.zeros((NLAT, NLON), np.float32)
        state = TriggerState(tt=1, thc=zero, windspeed=zero, winddir=zero)
        return ct.physics(state, w["pres"], w["u"][0], w["v"][0],
                          w["theta"][0], w["z"], w["std"], mask)
    return ct, step


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _tree(prof):
    """The port's spans as a nested list of ``(name, children)``, in order
    of start, each child inside its parent on the one host thread."""
    spans = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(PROGRAM)))
    root, stack = [], []                 # stack: (end, children)
    for start, neg, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((start - neg, node[1]))
    return root


def _names(tree):
    return [name for name, _ in tree]


def _waits(tree):
    return [n for name, kids in tree
            for n in ([name] if name.startswith("wait:") else [])
            + _waits(kids)]


def test_diag_spans_nest(world):
    _diag(world)                                  # warm: builds the caches
    prof = _profiled(lambda: _diag(world))
    tree = _tree(prof)
    assert _names(tree) == ["api:diag"]
    call = tree[0][1]
    assert _names(call) == ["api:probe", "api:run", "api:outputs"]
    probe, run, outputs = (kids for _, kids in call)
    # the probe reads back one integer a pass
    passes = [e.name() for e in prof.profiler.kineto_results.events()].count(
        "probe:transform")
    assert passes >= 1
    assert probe == [("pipeline:distance", [("wait:pad_coast_index", [])])
                     ] + [("wait:probe_readback", [])] * passes
    assert _names(run) == ["pipeline:inputs"] + ["pipeline:step"] * T
    for _, step in run[1:]:
        assert step == [
            ("pipeline:distance", [("wait:pad_coast_index", [])]),
            ("trigger:prepare", []), ("trigger:ring", [])]
    # the read-backs go through the staging slots, whose copies the CPU
    # completes where they are issued: the host blocks on none (on the card
    # a block on a slot's event is a ``wait:`` span)
    assert outputs == []
    # the unstaged moves read each field back at a ``wait:`` site
    tree = _tree(_profiled(lambda: _diag(world, use_kernels=False)))
    assert tree[0][1][-1] == ("api:outputs", [("wait:state_readback", [])] * 3
                              + [("wait:output_readback", [])])


def test_coupled_step_spans_and_waits(world):
    ct, step = _coupled(world)
    step()
    # the card's cells pad with slices, not with an uploaded index, as here
    assert ct.pipeline().nn_max < min(NLAT, NLON - 1)
    tree = _tree(_profiled(step))
    assert tree == [
        ("coupling:get_edges", []),
        ("coupling:get_dist", [("wait:pad_coast_index", [])]),
        ("coupling:seabreeze_diag", [("trigger:prepare", []),
                                     ("trigger:ring", [])])]
    # the sites a step passes: one index upload where the mask is made,
    # none in the physics call
    assert _waits(tree[:2]) == ["wait:pad_coast_index"]
    assert _waits(tree[2:]) == []


def test_h2d_bytes_counts_the_host_arrays_moved(world, quiet_tracer):
    _diag(world)
    assert not quiet_tracer.counters              # no profiler: no count
    _profiled(lambda: _diag(world))
    plane = NLAT * NLON * F4
    lev = 2                               # 66667 Pa, nearest 700 hPa
    assert world["pres"][lev] == np.float32(200000.0 / 3)
    want = (world["u"][:, lev:lev + 1].nbytes      # the level read, alone
            + world["v"][:, lev:lev + 1].nbytes
            + world["theta"].nbytes
            + world["ci"].nbytes          # the run's time-varying fields
            + 7 * plane                   # lsm, ci[0], z, std, thc, ws, wd
            + world["pres"][lev:lev + 1].nbytes)
    assert quiet_tracer.counters["h2d_bytes"] == want

    quiet_tracer.reset()
    _, step = _coupled(world)
    _profiled(step)
    want = (2 * plane                     # prepare_mask's land and ice
            + world["pres"].nbytes + world["u"][0].nbytes
            + world["v"][0].nbytes + 3 * plane   # theta, z, std
            + 3 * plane)                  # the state; the mask is a tensor
    assert quiet_tracer.counters["h2d_bytes"] == want


def test_tensors_on_the_device_count_nothing(world, quiet_tracer):
    ct, _ = _coupled(world)
    t = {k: torch.as_tensor(world[k]) for k in ("lsm", "z", "std", "pres")}

    def step():
        mask = ct.prepare_mask(t["lsm"])
        ct.physics(TriggerState.zeros((NLAT, NLON), "cpu"), t["pres"],
                   torch.as_tensor(world["u"][0]),
                   torch.as_tensor(world["v"][0]),
                   torch.as_tensor(world["theta"][0]), t["z"], t["std"],
                   mask)
    _profiled(step)
    assert quiet_tracer.counters.get("h2d_bytes", 0) == 0


def test_warmup_before_the_profiler_counts_nothing(world, quiet_tracer):
    for _ in range(2):
        _diag(world)
    _, step = _coupled(world)
    step()
    assert not quiet_tracer.counters and not quiet_tracer.records
    _profiled(lambda: _diag(world))
    once = quiet_tracer.counters["h2d_bytes"]
    _diag(world)                                  # after the profiler
    assert quiet_tracer.counters["h2d_bytes"] == once


def test_off_enters_no_profiler_range(world, quiet_tracer, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _, step = _coupled(world)
    _diag(world)
    step()
    assert entered == [] and not quiet_tracer.counters
    _profiled(step)                               # the patch takes effect
    assert "coupling:seabreeze_diag" in entered


def test_enabled_tracer_times_and_counts_the_coupled_step(world):
    tr = tracing.Tracer(enabled=True)
    ct = CoupledTrigger(grid=Grid(lon=world["lon"], lat=world["lat"]),
                        device="cpu", tracer=tr)
    mask = ct.prepare_mask(world["lsm"], world["ci"][0])
    ct.physics(TriggerState.zeros((NLAT, NLON), "cpu"), world["pres"],
               world["u"][0], world["v"][0], world["theta"][0], world["z"],
               world["std"], mask)
    labels = ("coupling:get_edges", "coupling:get_dist",
              "coupling:seabreeze_diag")
    assert all(tr.records[k].calls == 1 for k in labels)
    # the coupling's moves count in its own tracer, not the global one
    assert tr.counters["h2d_bytes"] > 0
    assert not tracing.tracer.counters
    assert "h2d_bytes" in tr.report()


@pytest.mark.cuda
def test_enabled_tracer_reports_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device column times CUDA "
                    "events")
    tr = tracing.Tracer(enabled=True)
    a = torch.randn(2048, 2048, device="cuda")
    with tr.hook("outer"):
        for _ in range(4):
            with tr.hook("inner"):
                a = a @ a
                a = a / a.norm()
    tr.count("h2d_bytes", 8)
    rep = tr.report().splitlines()
    assert "device_ms" in rep[0] and "dev_self_ms" in rep[0]
    row = {line.split()[0]: line.split() for line in rep[1:3]}
    assert float(row["inner"][4]) > 0 and float(row["outer"][4]) > 0
    # the outer span's device time holds its four inner spans'
    assert float(row["outer"][4]) >= float(row["inner"][4]) * 0.99
    assert tr.records["inner"].calls == 4
    assert rep[-1].split() == ["h2d_bytes", "8"]
