#!/usr/bin/env python3
"""Time the designs of kernels B1 and B2 side by side on one NVIDIA GPU.

    python3 tools/compare_designs.py [--against NAME=DIR ...] [--reps N]

Builds, with one ``nvcc`` per library, all started together:

* ``this``: the port's kernels, ``seabreeze_param_tpu_torch/csrc/
  {ring_trigger,pass2_min}.cu``;
* ``NAME`` for each ``--against NAME=DIR``: the same files of another
  checkout (e.g. ``parent=build/parent``, a ``git archive`` of the parent
  commit);
* B2 ``window``, ``window16``, ``window4`` and ``window_deep``:
  ``tools/designs/pass2_min_window.cu``, a register sliding window over
  tall tiles of 64 x 128 outputs (8 rows x 8 threads, 16 x 4 or 4 x 16 per
  column of threads, four Mmin rows in flight per thread; ``window_deep``
  8 x 8 with eight in flight);
* B1 ``variants``, ``prefetch``, ``tall`` and ``tall_prefetch``:
  ``tools/designs/ring_trigger_variants.cu`` with the port's design, the
  next tile's strip staged with ``cp.async`` during this tile's ring loop,
  32 x 32 tiles of two cells per thread, and both.

Then, at global 0.25 and 0.1 degrees on the inputs of ``chip_smoke.py``'s
B1 and B2 phases, holds every build bit-equal to the plain version and
times it with ``chip_smoke.device_ms`` in the order of the list and then
reversed: with the L2 flushed by a write before each call (the smoke's
timing), flushed by a read (no dirty lines to write back), and warm (the
inputs left in L2 by the call before).  Prints ``ptxas`` lines, one line
per build and size, and a JSON line ``{"designs": ...}`` of the device
times in microseconds (flushed by a write, mean of the two passes; the
others under ``read`` and ``warm``).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "seabreeze_param_tpu_torch" / "csrc"
DESIGNS = ROOT / "tools" / "designs"
OUT = ROOT / "build" / "designs"
#: How device_ms leaves the L2 before each call: flushed by a write (the
#: smoke's timing), flushed by a read, warm.
MODES = {"write": True, "read": "read", "warm": False}
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v")


def builds(against):
    """{kernel: {name: (source, extra flags)}}."""
    b2 = {"this": (CSRC / "pass2_min.cu", ())}
    b1 = {"this": (CSRC / "ring_trigger.cu", ())}
    for name, root in against.items():
        src = Path(root) / "seabreeze_param_tpu_torch" / "csrc"
        b2[name] = (src / "pass2_min.cu", ())
        b1[name] = (src / "ring_trigger.cu", ())
    win = DESIGNS / "pass2_min_window.cu"
    b2["window"] = (win, ())
    b2["window16"] = (win, ("-DSBZ_WINDOW_R=16", "-DSBZ_WINDOW_TY=4"))
    b2["window4"] = (win, ("-DSBZ_WINDOW_R=4", "-DSBZ_WINDOW_TY=16"))
    b2["window_deep"] = (win, ("-DSBZ_WINDOW_DEPTH=8",))
    var = DESIGNS / "ring_trigger_variants.cu"
    b1["variants"] = (var, ())
    b1["prefetch"] = (var, ("-DSBZ_RING_PREFETCH=1",))
    b1["tall"] = (var, ("-DSBZ_RING_CPT=2",))
    b1["tall_prefetch"] = (var, ("-DSBZ_RING_CPT=2", "-DSBZ_RING_PREFETCH=1"))
    return {"B2": b2, "B1": b1}


def build_all(table):
    """Compile every build at once; {(kernel, name): ctypes.CDLL}."""
    from seabreeze_param_tpu_torch.ops.cuda import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for kern, names in table.items():
        for name, (src, extra) in names.items():
            lib = OUT / f"lib_{kern}_{name}.so"
            procs[kern, name] = (lib, subprocess.Popen(
                [nvcc, *FLAGS, *extra, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log[-4000:]}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"# {key[0]} {key[1]} ptxas {line.strip()[-110:]}")
        lib = ctypes.CDLL(str(path))
        for fn, args in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def b2_inputs(name):
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, effective_radius, pad_coast, pass1_extrema)
    grid, _, _ = cs.world_grid(name)
    nlat, nlon = GRIDS[name]
    lsm, _, _, _, _, _, _, ci = make_world(nlat, nlon, 1, 1, seed=3)
    dev = torch.device("cuda")
    k = effective_radius(grid, 180.0)
    sdphi2, po, sdlam2 = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci[0], device=dev))
    return pass1_extrema(pad_coast(coast, k), sdlam2, k), sdphi2, po, k


def b2_case(name):
    """(check, make_call) for B2 at ``name``."""
    import torch
    from seabreeze_param_tpu_torch.ops.distance import pass2_min
    Mmin, sdphi2, po, k = b2_inputs(name)
    h, w = Mmin.shape[0] - 2 * k, Mmin.shape[1]
    ref = pass2_min(Mmin, sdphi2, po, k)
    out = torch.empty((h, w), device=Mmin.device)

    def make_call(lib):
        def call():
            err = lib.sbz_pass2_min(Mmin.data_ptr(), sdphi2.data_ptr(),
                                    po.data_ptr(), out.data_ptr(), h, w, k,
                                    stream())
            assert err == 0, f"sbz_pass2_min: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return bool(torch.equal(out, ref))
    return check, make_call


def b1_case(name):
    """(check, make_call) for B1 at ``name``: one step of the main world
    (tt = 15, a wind refresh), every tile holding a coastal cell in the
    ever-coastal set at the build's tile."""
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import StackedScan
    from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                       trigger_cells)
    grid, _, _ = cs.world_grid(name)
    nlat, nlon = GRIDS[name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, 3, seed=3)
    dev = torch.device("cuda")
    pipe = TriggerPipeline(grid, device=dev)
    params, nn = Params(), pipe.nn_max
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cd = pipe.distance_field(D(lsm), D(ci[2]))
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[2]), D(u[2]), D(v[2]), cd, D(z), D(std), D(pres), params, nn)
    ws0 = torch.full((nlat, nlon), 5.0, device=dev)
    wd0 = torch.full((nlat, nlon), 90.0, device=dev)
    is_first, upd = cadence(15, params)
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                        is_first, upd, params, nn)
    bufs = [torch.empty((1, nlat, nlon), device=dev) for _ in range(3)]
    state = [ws0.clone(), wd0.clone()]
    f32 = np.float32

    def tile_of(lib):
        if not hasattr(lib, "sbz_ring_tile"):
            return (16, 32)
        th, tw = ctypes.c_int(), ctypes.c_int()
        lib.sbz_ring_tile(ctypes.byref(th), ctypes.byref(tw))
        return th.value, tw.value

    def make_call(lib):
        ever = cs.tile_mask(cd, params.maxdist, tile_of(lib))

        def call():
            err = lib.sbz_ring_trigger_stacked(
                t0_pad.data_ptr(), cd_pad.data_ptr(), cd.data_ptr(),
                ws_new.data_ptr(), wd_new.data_ptr(), state[0].data_ptr(),
                state[1].data_ptr(), ever.data_ptr(), bufs[0].data_ptr(),
                bufs[1].data_ptr(), bufs[2].data_ptr(), nlat, nlon, nn, 0,
                int(is_first), int(upd), 0, nlat,
                int(params.skip_last_lat_row), *(float(f32(x)) for x in (
                    params.maxdist, params.thresh_wind, params.thresh_winddir,
                    params.thresh_windch, params.thresh_thc)), stream())
            assert err == 0, f"sbz_ring_trigger_stacked: cudaError_t {err}"
        return call

    def check(lib):
        # the stacks pre-filled: what a tile never visited keeps
        pre = StackedScan(nlat, nlon, params, dev).init_buffers(1, ws0, wd0)
        for b, p in zip(bufs, pre):
            b.copy_(p)
        state[0].copy_(ws0)
        state[1].copy_(wd0)
        make_call(lib)()
        return all(torch.equal(b[0], r) for b, r in zip(bufs, ref[:3])) and (
            torch.equal(state[0], ref[3]) and torch.equal(state[1], ref[4]))
    return check, make_call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose csrc/ is also built")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    table = builds(dict(a.split("=", 1) for a in args.against))
    libs = build_all(table)
    # the timing's floor: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    floor = {m: cs.device_ms(lambda: one.add_(1.0), reps=args.reps,
                             flush=f) * 1e3 for m, f in MODES.items()}
    print(f"# timing floor (a one-element kernel): L2 flushed by a write "
          f"{floor['write']:.2f} us, by a read {floor['read']:.2f}, warm "
          f"{floor['warm']:.2f}", flush=True)
    result = {"floor": floor}
    for kern, case in (("B2", b2_case), ("B1", b1_case)):
        for size in ("global025", "global010"):
            check, make_call = case(size)
            names = list(table[kern])
            times = {(n, m): [] for n in names for m in MODES}
            for name in names + names[::-1]:
                lib = libs[kern, name]
                if not check(lib):
                    raise AssertionError(f"{kern} {name} {size}: not "
                                         "bit-equal to the plain version")
                for m, flush in MODES.items():
                    times[name, m].append(cs.device_ms(
                        make_call(lib), reps=args.reps, flush=flush) * 1e3)
            mean = {k: sum(t) / len(t) for k, t in times.items()}
            for name in names:
                t = times[name, "write"]
                print(f"# {kern} {size} {name:14s} bit-equal; device "
                      f"{t[0]:.2f} / {t[1]:.2f} us (forward / reversed), "
                      f"L2 flushed by a read {mean[name, 'read']:.2f}, "
                      f"warm {mean[name, 'warm']:.2f}", flush=True)
            out = result.setdefault(kern, {})
            out[size] = {n: mean[n, "write"] for n in names}
            for m in ("read", "warm"):
                out.setdefault(m, {})[size] = {n: mean[n, m] for n in names}
    print(json.dumps({"designs": result, "device": smi.splitlines()[0],
                      "unit": "us, mean of the two passes"}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
