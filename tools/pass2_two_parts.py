#!/usr/bin/env python3
"""Where B2's two-extremum form spends its time past its staged build, on
one NVIDIA GPU.

    python3 tools/pass2_two_parts.py [--k 387] [--reps 20]

On ``chip_smoke.two_extremum_inputs`` (pass 1's extrema of the smoke's
main world, global 0.25 deg, at radius k) with po drawn from [-1, 1] and
with the grid's own po: the form through the port's wrapper, held
bit-equal to its plain version, its device time (``chip_smoke.device_ms``,
L2 flushed before each call), and the device time of each of the three
kernels of one call under ``torch.profiler`` (the padded rows' extrema,
the exit's bound table, the pass-2 routine); beside them the single form
on the same Mmin with the grid's po.

Prints one line per kernel and a JSON line ``{"pass2_two_parts": ...}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tools.sweep_parts import kernel_times  # noqa: E402

NAMES = r"two_row_extrema|two_bound|pass2_pruned_kernel|pass2_min_kernel"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=387)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda, pass2_min_two_cuda, pass2_min_two_limits)
    from seabreeze_param_tpu_torch.ops.distance import pass2_min
    if not torch.cuda.is_available():
        print("pass2_two_parts: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    k = args.k
    if k <= pass2_min_two_limits():
        raise SystemExit(f"k = {k} takes the staged build (one kernel)")
    grid, (lsm, *_, ci) = cs.main_world()
    mmin, mmax, sdphi2, pos, rows = cs.two_extremum_inputs(
        grid, lsm, ci[0], k, torch.device("cuda"))
    res = {}
    for kind, po in pos.items():
        def call(po=po):
            return pass2_min_two_cuda(mmin, mmax, sdphi2, po, k)
        if not torch.equal(call(), pass2_min(mmin, sdphi2, po, k,
                                             Mmax=mmax)):
            raise AssertionError(f"{kind} po: not bit-equal to plain")
        us = cs.device_ms(call, reps=args.reps) * 1e3
        parts = kernel_times(call, NAMES)
        print(f"# k = {k}, {kind} po: {us:.1f} us a call (bit-equal to "
              "plain)", flush=True)
        for name, (n, t) in sorted(parts.items(), key=lambda kv: -kv[1][1]):
            print(f"#   {name} x{n}: {t:.1f} us", flush=True)
        res[kind] = {"us": us, "kernels": parts}

    def single():
        return pass2_min_cuda(mmin, sdphi2, pos["grid"], k,
                              row_monotone=rows)
    res["single"] = {"us": cs.device_ms(single, reps=args.reps) * 1e3,
                     "kernels": kernel_times(single, NAMES)}
    print(f"# k = {k}, the single form on the grid's po: "
          f"{res['single']['us']:.1f} us a call", flush=True)
    print(json.dumps({"pass2_two_parts": {"k": k, "device": smi, **res}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
