#!/usr/bin/env python3
"""The main path of this checkout against another's, in pairs of fresh
processes on one NVIDIA GPU.

    python3 tools/compare_main_path.py --against DIR [--pairs N]

Each run is one process that imports the package of one checkout (this
one, or ``DIR``, e.g. a ``git archive`` of the parent commit) and drives
``chip_smoke.phase_main`` of this checkout: ``diag`` at global 0.25 deg,
32 steps with moving sea ice (kernel path and plain path, each after a
warm-up call), and ``TriggerPipeline.run`` with the inputs resident on
the card.  The harness is the same on both sides; only the package
differs.  Runs alternate in pairs (this first in even pairs, ``DIR`` first
in odd ones).  Prints one line per run and a JSON line ``{"main_path":
...}`` with each side's runs, medians and quartile spread, in ms/step.
Imports nothing of JAX.
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
KEYS = ("ms_per_step", "plain_ms_per_step", "resident_kernel",
        "resident_plain")

RUN = """
import importlib.util, json, sys
sys.path.insert(0, {side!r})
spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
out = {{}}
cs.phase_main(out)
print(json.dumps(dict(
    ms_per_step=out["ms_per_step"],
    plain_ms_per_step=out["plain_ms_per_step"],
    resident_kernel=out["resident_ms_per_step"]["kernel"],
    resident_plain=out["resident_ms_per_step"]["plain"],
    launches=out["launches"])))
"""


def run(side: Path):
    """One process on ``side``'s package; its main-path numbers."""
    code = RUN.format(side=str(side), smoke=str(ROOT / "chip_smoke.py"))
    p = subprocess.run([sys.executable, "-c", code], cwd=side,
                       capture_output=True, text=True, timeout=600)
    if p.returncode:
        raise RuntimeError(f"{side}: rc {p.returncode}\n{p.stdout[-2000:]}"
                           f"\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def summary(runs):
    out = {}
    for key in KEYS:
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
    args = ap.parse_args()
    sides = {"this": ROOT, "against": Path(args.against).resolve()}
    runs = {name: [] for name in sides}
    for i in range(args.pairs):
        order = ("this", "against") if i % 2 == 0 else ("against", "this")
        for name in order:
            r = run(sides[name])
            runs[name].append(r)
            print(f"# pair {i} {name:8s} diag {r['ms_per_step']:.3f} "
                  f"(plain {r['plain_ms_per_step']:.3f}) ms/step, resident "
                  f"{r['resident_kernel']:.3f} (plain "
                  f"{r['resident_plain']:.3f}); launches {r['launches']}",
                  flush=True)
    print(json.dumps({"main_path": {name: summary(r)
                                    for name, r in runs.items()},
                      "against": str(sides["against"])}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
