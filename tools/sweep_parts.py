#!/usr/bin/env python3
"""Where the ring kernels' sweep build (NN past 2047) spends its time, on
one NVIDIA GPU.

    python3 tools/sweep_parts.py [--nn 2204] [--rows 64] [--reps 20]

On ``chip_smoke.py``'s land field (64 x 128 cells by default, ``--rows``
sets the rows; every cell within maxdist, no window holding both classes,
so every cell runs to NN) padded at NN: B5, the ring search alone, through
the port's wrapper, held bit-equal to its plain version, its device time
(``chip_smoke.device_ms``, L2 flushed before each call), and the device
time of each kernel of one call under ``torch.profiler`` (the integral
image, the latch, the catch-up, the band launches, the outputs).

Prints one line per kernel and a JSON line ``{"sweep_parts": ...}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def kernel_times(call, names=r"sweep_\w+|land_\w+|Memset|Memcpy"):
    """{kernel name: (launches, device µs)} of one call under
    ``torch.profiler``, each name shortened to its match of ``names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(names, e.name)
        name = m.group(0) if m else e.name[:40]
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + 1, t + e.device_time)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nn", type=int, default=2204)
    ap.add_argument("--rows", type=int, default=cs.PAST_FIELD[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_thc_cuda_padded)
    from seabreeze_param_tpu_torch.ops.ring_search import (
        ring_quantities, ring_thc_from_padded)
    if not torch.cuda.is_available():
        print("sweep_parts: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    nn, h, w = args.nn, args.rows, cs.PAST_FIELD[1]
    rng = np.random.default_rng(nn)
    D = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    cd_pad = D((50.0 + 100.0 * rng.random((h + 2 * nn, w + 2 * nn)))
               .astype(np.float32))
    t0_pad = D((280.0 + 10.0 * rng.random(cd_pad.shape)).astype(np.float32))
    cd = cd_pad[nn:nn + h, nn:nn + w].contiguous()
    ref = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                               torch.where(cd >= 0, 1.0, -1.0), nn,
                               coastal=cd.abs() <= 180.0)[0]

    def call():
        return ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)

    if not torch.equal(call(), ref):
        raise AssertionError("B5 is not bit-equal to its plain version")
    us = cs.device_ms(call, reps=args.reps) * 1e3
    kernels = kernel_times(call)
    print(f"# B5 at NN = {nn} on {h} x {w} land: {us:.1f} us a call "
          "(bit-equal to plain)", flush=True)
    for k, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        print(f"# {k} x{n}: {t:.1f} us", flush=True)
    print(json.dumps({"sweep_parts": {
        "nn": nn, "field": [h, w], "device": smi, "us": us,
        "kernels": kernels}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
