"""The readers of the port's spans and counter (``spans.py`` and its six
metric files) on a synthetic :class:`trace.Window` whose device and host
intervals, and so every reading, are known."""
from __future__ import annotations

import sys
import types

import pytest

from portbench import harness, readers, spans
from portbench.trace import Window

#: The window's span on the profiler's time base (us).
SPAN = (1000.0, 2000.0)
#: Device events: busy 1100-1300, 1250-1400 (overlapping), 1700-1800.
DEVICE = [("ring_kernel", 1100.0, 1300.0), ("Memcpy HtoD", 1250.0, 1400.0),
          ("elementwise", 1700.0, 1800.0)]
#: Host events: the benchmark's loop, one call of the port's (spans
#: 1050-1450 and 1600-1900, nested ones inside), aten ops, and spans that
#: cross the window's edges.
HOST = [
    ("portbench.diag_call", 1040.0, 1460.0),
    ("api:diag", 1050.0, 1450.0),
    ("api:probe", 1050.0, 1150.0),
    ("wait:probe_readback", 1120.0, 1140.0),
    ("api:run", 1150.0, 1420.0),
    ("pipeline:step", 1160.0, 1300.0),
    ("wait:pad_coast_index", 1170.0, 1175.0),
    ("aten::add", 1180.0, 1190.0),
    ("api:outputs", 1420.0, 1450.0),
    ("wait:state_readback", 1430.0, 1440.0),
    ("coupling:seabreeze_diag", 1600.0, 1900.0),
    ("api:probe", 1980.0, 2100.0),        # runs past the window's end
    ("wait:output_readback", 950.0, 1010.0),   # starts before it
]
STEPS = 4


def synthetic(device=DEVICE, host=HOST, steps=STEPS):
    win = Window(trace=True, cuda=True)
    win.span, win.device, win.host = SPAN, list(device), list(host)
    return types.SimpleNamespace(window=win, steps=steps, work={})


def test_program_idle_share():
    # program spans open 1000-1010, 1050-1450, 1600-1900 and 1980-2000
    # (the first and last clipped): 730 us; the device busy inside them
    # 1100-1400 and 1700-1800: 400 us
    run = synthetic()
    assert spans.program_idle_share(run) == pytest.approx(100 * 330 / 1000)
    # never above the device's whole idle share (busy 400 of 1000 us)
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert spans.program_idle_share(run) <= readers.idle_share(run)


def test_waits_and_probe():
    run = synthetic()
    # three wait spans start inside the window; the fourth before it
    assert spans.waits_per_step(run) == pytest.approx(3 / STEPS)
    # api:probe 100 us, and 20 us of the one cut at the window's end
    assert spans.span_ms_per_step(run, "api:probe") == pytest.approx(
        0.120 / STEPS)


def test_merged_and_overlap():
    assert spans.merged([(3, 4), (1, 2), (1.5, 2.5), (5, 5)]) == [
        [1, 2.5], [3, 4]]
    assert spans.overlap([[0, 10]], [[2, 3], [5, 12]]) == 6
    assert spans.overlap([[0, 1], [4, 6]], [[1, 4]]) == 0


@pytest.fixture
def port_tracer(monkeypatch):
    """A stand-in for the port's loaded tracing module."""
    mod = types.ModuleType(spans.TRACING_MODULE)
    mod.tracer = types.SimpleNamespace(counters={})
    monkeypatch.setitem(sys.modules, spans.TRACING_MODULE, mod)
    return mod.tracer


def test_counter(port_tracer):
    port_tracer.counters["h2d_bytes"] = 8_000_000
    assert spans.counter_per_step(synthetic(), "h2d_bytes", 1e6) == 2.0


def test_nothing_to_read_is_none(port_tracer, monkeypatch):
    quiet = synthetic(device=[])                  # no device event traced
    port_tracer.counters["h2d_bytes"] = 8
    assert spans.counter_per_step(quiet, "h2d_bytes") is None
    assert spans.waits_per_step(quiet) is None
    assert spans.program_idle_share(quiet) is None
    # a program with none of the spans, or no such counter
    bare = synthetic(host=[("portbench.diag_call", 1040.0, 1460.0)])
    assert spans.waits_per_step(bare) is None
    assert spans.span_ms_per_step(bare, "api:probe") is None
    assert spans.program_idle_share(bare) is None
    port_tracer.counters.clear()
    assert spans.counter_per_step(synthetic(), "h2d_bytes") is None
    del port_tracer.counters                      # a tracer without them
    assert spans.counter_per_step(synthetic(), "h2d_bytes") is None
    monkeypatch.delitem(sys.modules, spans.TRACING_MODULE)
    assert spans.counter_per_step(synthetic(), "h2d_bytes") is None
    untraced = synthetic()
    untraced.window.trace = False
    assert spans.span_ms_per_step(untraced, "api:probe") is None


NEW = {"probe_ms_per_step.diag": 0.120 / STEPS,
       "h2d_mb_per_step.diag": 2.0,
       "host_waits_per_step.diag": 3 / STEPS,
       "host_waits_per_step.coupled": 3 / STEPS,
       "program_idle_share.diag": 33.0,
       "program_idle_share.coupled": 33.0}


@pytest.mark.parametrize("name", sorted(NEW))
def test_metric_files_read_the_synthetic_window(name, port_tracer):
    port_tracer.counters["h2d_bytes"] = 8_000_000
    got = harness.load_module("metrics", name).read(synthetic())
    assert got == pytest.approx(NEW[name])
    entry = next(m for m in harness.spec()["per_layer"] if m["name"] == name)
    assert entry["source"] in ("program_span", "program_counter")
