#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 tools/profile_main_path.py [--sharded | --driver | --wide]
                                       [--trace DIR]

Uses the world of ``chip_smoke.py``'s main phase (global 0.25 deg, 4
levels, 32 steps, moving polar sea ice) and prints two reports (with
``--sharded``, the first one alone, for the decomposed run instead:
``ShardedPipeline.run`` on ``chip_smoke``'s 2 x 4 mesh over its 16 steps,
overlapped and basic structures on the kernel path):

1. **Resident loop under the profiler.**  ``TriggerPipeline.run`` with every
   input already on the card, kernel path and plain path, one warm-up run
   each, the median wall time of 10 runs without the profiler, then one
   run under ``torch.profiler``: the wall time, the device's busy time (the
   union of the intervals of its kernels and copies) and so its idle
   share, when the host returned from its last kernel launch and when the
   device ended, the device kernels per step, the device time of the
   heaviest kernels by name and of each of the port's own kernels, and
   the host ops by self time.  With ``--trace DIR`` each profiled run is
   also written to ``DIR`` as a Chrome trace (``LABEL.json``).
   Falls back to CUDA events for the wall time alone when the profiler sees
   no device activity.
2. **Breakdown of one ``diag`` call.**  Each part timed alone, best of 3,
   in ms per call of 32 steps: ``diag`` itself (with and without
   ``full_output``), the host-to-device copy of the inputs from pageable
   and from pinned memory, the ring-radius probe (its distance field on the
   card, the host transform), the resident loop, and the copy back of
   sb_con and of all four output fields.  With ``--driver``, this report
   alone, for the call the batch driver makes per file: the world's first
   4 steps (``chip_smoke``'s driver phase).

With ``--wide``, the first report alone, on ``chip_smoke``'s 0.4 km world
(1024 x 1024 at 0.0036 deg from 54 N, 2 steps, k = 387, NN = 391) for
``TriggerPipeline.run`` on the kernel path with the fused distance (B3's
large build) and with the hybrid one (torch pass 1 and B2's unstaged
build).

Imports nothing of JAX.  Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def log(msg):
    print(msg, flush=True)


def wall_ms(fn, reps=3):
    """Best wall time of ``fn`` in ms over ``reps`` calls, the device
    synchronised before and after each."""
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def busy_ms(intervals):
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_resident(world, top=15, sharded=False, wide=False,
                     trace_dir=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline

    grid, arrays = world
    dev = torch.device("cuda")
    theta, u, v, lsm, z, std, pres, ci = (
        torch.as_tensor(a, device=dev) for a in (
            arrays[4], arrays[5], arrays[6], arrays[0], arrays[1],
            arrays[2], arrays[3], arrays[7]))
    if sharded:
        from chip_smoke import SHARD_MESH, SHARD_STEPS
        from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
        from seabreeze_param_tpu_torch.parallel.sharded import (
            ShardedPipeline)
        theta, u, v, ci = (a[:SHARD_STEPS] for a in (theta, u, v, ci))
        mesh = make_mesh(SHARD_MESH, dev)
        pipe = TriggerPipeline(grid, device=dev)
        runners = {f"sharded {SHARD_MESH} {label}": ShardedPipeline(
            pipe, mesh, overlap=label == "overlapped")
            for label in ("overlapped", "basic")}
    elif wide:
        runners = {f"0.4 km {impl}": TriggerPipeline(
            grid, device=dev, distance_impl=impl)
            for impl in ("fused", "hybrid")}
    else:
        runners = {label: TriggerPipeline(grid, device=dev, use_kernels=uk)
                   for label, uk in (("kernel", None), ("plain", False))}
    T = theta.shape[0]
    for label, pipe in runners.items():

        def run():
            pipe.run(TriggerState.zeros(grid.shape, dev), theta, u, v, lsm,
                     z, std, pres, ci_t=ci)

        run()                                             # warm-up
        walls = sorted(wall_ms(run, reps=1) for _ in range(10))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
        if not dev_events:
            log(f"## {label}: the profiler saw no device activity; "
                f"CUDA-event wall {wall_ms(run):.3f} ms for {T} steps")
            continue
        busy = busy_ms([(e.time_range.start, e.time_range.end)
                        for e in dev_events]) / 1e3
        t0_us = min(e.time_range.start for e in prof.events())
        launched = max((e.time_range.end for e in prof.events()
                        if e.name.startswith(("cudaLaunchKernel",
                                              "cuLaunchKernel"))),
                       default=t0_us)
        ended = max(e.time_range.end for e in dev_events)
        log(f"## {label}: wall {wall:.3f} ms for {T} steps "
            f"({wall / T:.4f} ms/step, profiler on; without it "
            f"{walls[4] / T:.4f} ms/step, median of 10, range "
            f"{walls[0] / T:.4f}-{walls[-1] / T:.4f}); device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; the host's "
            f"last launch returned at {(launched - t0_us) / 1e3:.3f} ms, "
            f"the device ended at {(ended - t0_us) / 1e3:.3f} ms; "
            f"{len(dev_events) / T:.1f} device kernels and copies per step")
        if trace_dir is not None:
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(Path(trace_dir) / (label.replace(" ", "_") + ".json")))
        by_name = {}
        for e in dev_events:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        for name, (n, ms) in ranked[:top]:
            log(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
        own = [(re.search(r"namespace\)::(\w+(?:<\d+>)?)", name), n, ms)
               for name, (n, ms) in ranked if "at::native" not in name]
        log("  the port's own kernels: " + "; ".join(
            f"{m.group(1)} {ms:.3f} ms {n}x ({ms / n * 1e3:.1f} us each)"
            for m, n, ms in own if m))
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        log("  host, by self time: " + "; ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms {e.count}x"
            for e in host[:top]))


def breakdown(world):
    import torch
    from seabreeze_param_tpu_torch.api import diag, ring_radius
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline

    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    dev = torch.device("cuda")
    T = theta.shape[0]
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    parts = {}
    parts["diag"] = wall_ms(lambda: diag(*args, device=dev))
    parts["diag full_output"] = wall_ms(
        lambda: diag(*args, device=dev, full_output=True))

    large = (theta, u, v, ci)
    parts["H2D inputs, pageable"] = wall_ms(lambda: [
        torch.as_tensor(a, device=dev) for a in
        (lsm, z, std, pres) + large])
    pinned = [torch.from_numpy(a).pin_memory() for a in large]
    parts["H2D 4 large inputs, pinned"] = wall_ms(lambda: [
        p.to(dev, non_blocking=True) for p in pinned])

    pipe = TriggerPipeline(grid, device=dev)
    lsm_d = torch.as_tensor(lsm, device=dev)
    ci0 = torch.as_tensor(ci[0], device=dev)
    parts["probe distance + D2H"] = wall_ms(
        lambda: pipe.distance_field(lsm_d, ci0).cpu().numpy())
    cd0 = pipe.distance_field(lsm_d, ci0).cpu().numpy()
    parts["probe host transform"] = wall_ms(
        lambda: ring_radius(cd0, Params(), pipe.k))

    d = [torch.as_tensor(a, device=dev)
         for a in (theta, u, v, lsm, z, std, pres, ci)]
    outs = {}

    def loop():
        outs.update(pipe.run(TriggerState.zeros(grid.shape, dev), *d[:7],
                             ci_t=d[7])[1])
    parts["resident loop"] = wall_ms(loop)
    parts["D2H sb_con"] = wall_ms(lambda: outs["sb_con"].cpu().numpy())
    parts["D2H 4 output fields"] = wall_ms(
        lambda: [o.cpu().numpy() for o in outs.values()])

    nbytes = sum(a.nbytes for a in (lsm, z, std, pres) + large)
    log(f"## breakdown of one diag call ({T} steps, inputs "
        f"{nbytes / 1e9:.3f} GB), ms per call, best of 3:")
    for name, ms in parts.items():
        log(f"  {name:28s} {ms:10.3f}  ({ms / parts['diag']:.3f} of diag)")


def main():
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import main_world
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0])
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}")
    args = sys.argv[1:]
    trace_dir = args[args.index("--trace") + 1] if "--trace" in args else None
    if "--wide" in args:
        from chip_smoke import WIDE_WORLDS, wide_world
        profile_resident(wide_world(WIDE_WORLDS[0][1]), wide=True,
                         trace_dir=trace_dir)
        return 0
    world = main_world()
    if "--sharded" in args:
        profile_resident(world, sharded=True, trace_dir=trace_dir)
        return 0
    if "--driver" in args:
        from chip_smoke import DRIVER_STEPS
        grid, (lsm, z, std, pres, *series) = world
        breakdown((grid, (lsm, z, std, pres,
                          *(a[:DRIVER_STEPS] for a in series))))
        return 0
    profile_resident(world, trace_dir=trace_dir)
    breakdown(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
