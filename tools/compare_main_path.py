#!/usr/bin/env python3
"""The main path (or the decomposed run) of this checkout against
another's, in pairs of fresh processes on one NVIDIA GPU.

    python3 tools/compare_main_path.py --against DIR [--pairs N]
                                       [--phase main|sharded|fine|km|wide]

Each run is one process that imports the package of one checkout (this
one, or ``DIR``, e.g. a ``git archive`` of the parent commit) and drives
one phase of this checkout's ``chip_smoke.py``: ``phase_main`` (``diag``
at global 0.25 deg, 32 steps with moving sea ice, kernel path and plain
path, each after a warm-up call, and ``TriggerPipeline.run`` with the
inputs resident on the card), ``phase_sharded`` (``ShardedPipeline.run``
on a 2 x 4 mesh of the card, 16 steps of the same world: overlapped,
basic, plain, and the single-device run), or the ``diag`` of a regional
phase, ``regional_diag`` over ``fine_world`` (1024 x 1024 at 0.015 deg,
8 steps) or ``km_world`` (1024 x 1024 at 0.009 deg, 4 steps), kernel path
and plain path after a warm-up call, or (``wide``) ``resident_run`` of the
fused distance over the 0.4 km world (1024 x 1024 at 0.0036 deg, k = 387,
2 steps, inputs on the card), the median of 5 runs after a warm-up.  The harness is the same on
both sides; only the package differs.  Runs alternate in pairs (this first
in even pairs, ``DIR`` first in odd ones).  Prints one line per run and a
JSON line ``{"main_path": ...}`` with each side's runs, medians and
quartile spread, in ms/step.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: Per phase, the numbers kept: name -> path into the phase's output.
KEYS = {
    "main": {"ms_per_step": ("ms_per_step",),
             "plain_ms_per_step": ("plain_ms_per_step",),
             "resident_kernel": ("resident_ms_per_step", "kernel"),
             "resident_plain": ("resident_ms_per_step", "plain")},
    "sharded": {"overlap": ("ms_per_step", "overlap"),
                "basic": ("ms_per_step", "basic"),
                "plain": ("ms_per_step", "plain"),
                "single": ("ms_per_step", "single")},
    "fine": {"ms_per_step": ("ms_per_step",),
             "plain_ms_per_step": ("plain_ms_per_step",)},
    "km": {"ms_per_step": ("ms_per_step",),
           "plain_ms_per_step": ("plain_ms_per_step",)},
    "wide": {"resident_fused": ("ms_per_step",)},
}
#: Per phase, the statement that fills ``out``.
DRIVE = {
    "main": "cs.phase_main(out)",
    "sharded": "cs.phase_sharded(out)",
    "fine": "out.update(cs.regional_diag(cs.fine_world(), 'fine', 1))",
    "km": "out.update(cs.regional_diag(cs.km_world(), '1 km', 1))",
    "wide": "r = cs.resident_run(cs.wide_world(cs.WIDE_WORLDS[0][1]), "
            "'fused', reps=5); out.update(launches=r['launches'], "
            "ms_per_step=r['ms_per_step'])",
}

RUN = """
import importlib.util, json, sys
sys.path.insert(0, {side!r})
spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
out = {{}}
{drive}
print(json.dumps(out))
"""


def run(side: Path, phase: str):
    """One process on ``side``'s package; the phase's numbers."""
    code = RUN.format(side=str(side), smoke=str(ROOT / "chip_smoke.py"),
                      drive=DRIVE[phase])
    p = subprocess.run([sys.executable, "-c", code], cwd=side,
                       capture_output=True, text=True, timeout=600)
    if p.returncode:
        raise RuntimeError(f"{side}: rc {p.returncode}\n{p.stdout[-2000:]}"
                           f"\n{p.stderr[-4000:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res = {"launches": out["launches"]}
    for key, path in KEYS[phase].items():
        v = out
        for k in path:
            v = v[k]
        res[key] = v
    return res


def summary(runs, phase):
    out = {}
    for key in KEYS[phase]:
        v = np.array([r[key] for r in runs])
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        out[key] = dict(runs=v.tolist(), median=float(med),
                        quartile_spread=float(q3 - q1))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="the other checkout (e.g. build/parent)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--phase", choices=sorted(KEYS), default="main")
    args = ap.parse_args()
    sides = {"this": ROOT, "against": Path(args.against).resolve()}
    runs = {name: [] for name in sides}
    for i in range(args.pairs):
        order = ("this", "against") if i % 2 == 0 else ("against", "this")
        for name in order:
            r = run(sides[name], args.phase)
            runs[name].append(r)
            print(f"# pair {i} {name:8s} {args.phase}, ms/step: " + ", ".join(
                f"{k} {r[k]:.3f}" for k in KEYS[args.phase])
                + f"; launches {r['launches']}", flush=True)
    print(json.dumps({"main_path": {name: summary(r, args.phase)
                                    for name, r in runs.items()},
                      "phase": args.phase,
                      "against": str(sides["against"])}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
