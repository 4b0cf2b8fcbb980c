"""The benchmark's driver: finds a cell's files by name, runs its path
once, and assembles the result line.

Everything that belongs to one cell, configuration, entry path or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: the cell's traffic (its path, steps, sea-ice
  cadence, window sampling) and the limits of the numbers it compares;
* ``configs/<config>.json``: the deployment (grid, levels, parameters);
* ``paths/<path>.py``: the driver of one entry path, ``run(ctx)``;
* ``metrics/<metric>.py``: the reader of one per-layer metric, ``read(run)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded in a run's process: JAX,
#: and the JAX package the port was written from.
FORBIDDEN = ("jax", "jaxlib", "flax", "seabreeze_param_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def spec():
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark's folder, as a module."""
    path = HERE / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a path driver is given: the cell's entry in ``BENCHMARK.json``
    (``entry``), its traffic file (``workload``), its configuration file
    (``config``), the run's arguments, the device, the host clock's reading
    at the run's start, and ``system``: None for the program under test,
    else a stand-in of the same interface (the control, or a fault in a
    test)."""

    cell: str
    entry: dict
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    system: object = None


@dataclasses.dataclass
class Outcome:
    """What a path driver returns.  ``end_to_end``: metric name -> value;
    ``compared``: the numbers that decide ``correct``, name -> (value,
    limit), each correct at or below its limit; ``window``: the
    :class:`trace.Window`; ``steps``: the steps completed in it;
    ``work``: kernel -> (bytes, operations) its inputs needed in the
    window, for the roofline readers."""

    setup_s: float
    end_to_end: dict
    attempted: int
    failed: int
    compared: dict
    window: object
    steps: int
    work: dict
    memory_peak_bytes: int


def context(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, system=None, overrides=None):
    """The :class:`Context` of ``cell``; ``overrides`` (tests) update the
    configuration's and the traffic's keys."""
    sp = spec()
    entry = next((w for w in sp["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in sp["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    for key, val in (overrides or {}).items():
        (config if key in config else workload)[key] = val
    return Context(cell, entry, workload, config, int(seed), float(seconds),
                   bool(trace), torch.device(device), t_start, system)


def cell_metrics(cell: str, trace: bool):
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), as entries of ``BENCHMARK.json``."""
    sp = spec()

    def here(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in sp["end_to_end"] if here(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in sp["per_layer"]
            if here(m) or (here(m) is None and m["moves"] in names)]


def device_info(device, chips: int, peak: int):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(ctx: Context):
    """Run the cell's path once and return ``(result, lines)``: the result
    line's object and the lines that name each compared number beside its
    limit."""
    path = load_module("paths", ctx.workload["path"])
    out: Outcome = path.run(ctx)
    metrics = {}
    for m in cell_metrics(ctx.cell, ctx.trace):
        if ctx.trace:
            value = load_module("metrics", m["name"]).read(out)
        elif m["name"] == "setup_s":
            value = out.setup_s
        else:
            value = out.end_to_end.get(m["name"])
            if value is None:
                raise RuntimeError(f"path {ctx.workload['path']!r} gave no "
                                   f"{m['name']!r}")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = (out.failed == 0 and out.attempted > 0
               and all(v <= lim for v, lim in out.compared.values()))
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info(ctx.device, ctx.entry["chips"],
                                    out.memory_peak_bytes)}
    if ctx.trace and out.window is not None and out.window.span:
        result["device"]["busy_s"] = out.window.busy_s()
        result["device"]["window_s"] = out.window.window_s
        result["breakdown"] = out.window.breakdown()
    result["compared"] = {k: {"value": float(v), "limit": float(lim)}
                          for k, (v, lim) in out.compared.items()}
    lines = [f"compared {k}: {v!r} (limit {lim!r})"
             for k, (v, lim) in out.compared.items()]
    return result, lines
