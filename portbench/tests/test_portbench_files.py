"""Every configuration, cell and metric file loads and keeps to the
benchmark's contract: names, units, keys, limits and cross-references."""
from __future__ import annotations

import re

import pytest

from portbench import compare, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.spec()


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and line_ok(conf["source"])
    assert line_ok(conf["why"])
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    data = harness.load_json(harness.ROOT / conf["file"])
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert all(NAME.match(k) for k in conf["reduced"])
    assert {"grid", "nlev", "params", "precision", "assumed"} <= set(data)
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and line_ok(cell["why"])
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    data = harness.load_json(harness.HERE / "workloads"
                             / f"{cell['name']}.json")
    assert data["why"] == cell["why"]
    assert (harness.HERE / "paths" / f"{data['path']}.py").exists()
    assert set(data["limits"]) == set(compare.Judge.NAMES)
    e2e = harness.cell_metrics(cell["name"], trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.cell_metrics(cell["name"], trace=True)


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and line_ok(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moves.get("workloads", [cell])
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    assert callable(harness.load_module("metrics", m["name"]).read)


def test_every_file_is_named():
    """Every configuration, cell and metric file under the benchmark's
    folder is one that ``BENCHMARK.json`` names."""
    names = {"configs": {c["name"] for c in SPEC["configs"]},
             "workloads": {w["name"] for w in SPEC["workloads"]},
             "metrics": {m["name"] for m in SPEC["per_layer"]}}
    for kind, want in names.items():
        have = {p.name.rsplit(".", 1)[0]
                for p in (harness.HERE / kind).iterdir()
                if p.suffix in (".json", ".py")}
        assert have == want, kind
