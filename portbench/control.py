"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--set key=json ...]

For each of ``--seeds`` it runs the cell's path on the program under test
(a short window at the cell's own size and load, every answer of it
compared), and for each of ``--control-seeds`` on the control, the plain
reference computed one precision below the configuration's (bfloat16 for
float32), put in the program's place.  Prints one JSON line a run with the
numbers compared (the lower reading is the largest over the program's
seeds, the upper the least over the control's); the benchmark's own runs
never run the control.  ``--set`` changes a key of the configuration or
the traffic for every run (``--set coupled_nn_max=null``: the coupling at
its default ring bound, a fault of the program the limits must catch).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON")
    args = ap.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in
                 (kv.split("=", 1) for kv in args.set)}
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              args.device, t0, overrides=overrides)
        path = harness.load_module("paths", ctx.workload["path"])
        if control:
            ctx.system = path.control_system(ctx)
        out = path.run(ctx)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "system": "control" if control else "program",
            "set": overrides,
            "attempted": out.attempted, "failed": out.failed,
            "compared": {k: v for k, (v, _) in out.compared.items()},
            "end_to_end": out.end_to_end, "setup_s": out.setup_s,
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
