"""Each entry path runs a tiny world through the port's plain path on the
CPU, untraced and traced, and its result line holds the contract's keys,
``compared`` last."""
from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.tests import helpers

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", helpers.CELLS)
def test_tiny_run(cell, trace):
    result, lines = helpers.run(cell, trace=bool(trace))
    keys = [k for k in result if k != "breakdown"]
    assert keys == KEYS
    assert json.loads(json.dumps(result)) == result
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device here: every per-layer reader finds nothing to read
        assert result["metrics"] == {}
    else:
        want = {m["name"] for m in harness.cell_metrics(cell, False)}
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert lines == [f"compared {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in result["compared"].items()]


def test_diag_path_takes_a_3d_pressure():
    """On a configuration with no ``pres_hpa`` (a model's own levels, as
    ``ral_1p5km``'s 70) the diag path passes one 3-D pressure a call."""
    ctx = helpers.context("era5_025.diag_ice")
    ctx.config = dict(harness.load_json(harness.HERE / "configs"
                                        / "ral_1p5km.json"),
                      grid=helpers.TINY_GRID, nlev=8)
    ctx.workload["timestep_min"] = 60.0
    result, _ = harness.run_cell(ctx)
    assert result["correct"] is True and result["attempted"] > 0
