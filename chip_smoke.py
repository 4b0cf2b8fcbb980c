#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``seabreeze_param_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, checks
the port's ``diag`` against the loop-faithful NumPy oracle on a small
world, then drives ``diag`` once at global 0.25 degrees (721 x 1440, 4
levels, 32 steps, moving polar sea ice) and holds it against the plain path.
Any failed check raises, so the exit code is non-zero.

Output: a line with the card's name and power limit (``nvidia-smi``), one
line per phase, a JSON line ``{"kernels": [...]}`` with each kernel's
launches on the main path, error against its plain version and times, and
as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MISSING = np.float32(2.0e20)
BIG = np.float32(1.0e30)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def world_grid(name):
    """(Grid, lon, lat) of one of ``bench.GRIDS``."""
    from bench import GRID_DOMAIN, GRIDS
    from seabreeze_param_tpu_torch.core.grid import Grid
    nlat, nlon = GRIDS[name]
    lat0, lat1, lon_span = GRID_DOMAIN.get(name, (90.0, -90.0, 360.0))
    grid = Grid.regular(nlat, nlon, lat0=lat0, lat1=lat1, lon1=lon_span)
    return grid, grid.lon, grid.lat


def check_fields(got, ref, what, *, bit_state=()):
    """MISSING structure equal, then rtol 2e-5 / atol 2e-4; ``bit_state``
    keys bit-equal.  Returns the max abs difference off MISSING."""
    worst = 0.0
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        if key in bit_state:
            if not np.array_equal(g, r):
                raise AssertionError(f"{what}: {key} not bit-equal, max "
                                     f"|diff| {np.abs(g - r).max()}")
            continue
        miss = r == MISSING
        if not np.array_equal(g == MISSING, miss):
            raise AssertionError(f"{what}: {key} MISSING structure differs")
        d = np.abs(g[~miss] - r[~miss])
        if d.size:
            worst = max(worst, float(d.max()))
        if not np.allclose(g[~miss], r[~miss], rtol=2e-5, atol=2e-4):
            raise AssertionError(f"{what}: {key} max |diff| {d.max()}")
    return worst


def phase_build():
    from seabreeze_param_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    log(f"# build: {secs:.1f} s ({_build.library_path().name})")
    for line in _build.BUILD_STATS["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"#   ptxas {line.strip()}")


def phase_pass2(name, out):
    """Kernel B2 against plain pass 2 on pass-1 output of a real world."""
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, effective_radius, pad_coast, pass1_extrema, pass2_min)

    grid, _, _ = world_grid(name)
    nlat, nlon = GRIDS[name]
    lsm, _, _, _, _, _, _, ci = make_world(nlat, nlon, 1, 1, seed=3)
    dev = torch.device("cuda")
    k = effective_radius(grid, 180.0)
    sdphi2, po, sdlam2 = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci[0], device=dev))
    Mmin = pass1_extrema(pad_coast(coast, k), sdlam2, k)
    got = pass2_min_cuda(Mmin, sdphi2, po, k).cpu().numpy()
    ref = pass2_min(Mmin, sdphi2, po, k).cpu().numpy()
    if not np.array_equal(got > BIG / 2, ref > BIG / 2):
        raise AssertionError(f"B2 {name}: BIG structure differs")
    sel = ref < BIG / 2
    err = float(np.abs(got[sel] - ref[sel]).max()) if sel.any() else 0.0
    if not np.array_equal(got[sel], ref[sel]):
        raise AssertionError(f"B2 {name}: not bit-equal, max |diff| {err}")
    ms = cuda_ms(lambda: pass2_min_cuda(Mmin, sdphi2, po, k))
    plain = cuda_ms(lambda: pass2_min(Mmin, sdphi2, po, k))
    log(f"# B2 pass2_min {name} k={k}: bit-equal to plain "
        f"({int(sel.sum())} finite cells); kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms")
    out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain)


def phase_ring(name, out):
    """Kernel B1 against the plain path: a 3-step scan entered at tt=14
    (crossing the tt=15 wind refresh), then the kernel alone on one step's
    inputs against ``trigger_cells``."""
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        StackedScan, ring_trigger_cuda_stacked)
    from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                       trigger_cells)

    grid, _, _ = world_grid(name)
    nlat, nlon = GRIDS[name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, 3, seed=3)
    dev = torch.device("cuda")
    runs = {}
    for label, uk in (("kernel", None), ("plain", False)):
        pipe = TriggerPipeline(grid, device=dev, use_kernels=uk)
        state = TriggerState(
            tt=14, thc=torch.zeros((nlat, nlon), device=dev),
            windspeed=torch.full((nlat, nlon), 5.0, device=dev),
            winddir=torch.full((nlat, nlon), 90.0, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, outs = pipe.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        torch.cuda.synchronize()
        runs[label] = ({k: o.cpu().numpy() for k, o in outs.items()},
                       st, (time.perf_counter() - t0) / 3 * 1e3)
    nn = pipe.nn_max
    fin = {lab: {"thc": r[1].thc.cpu().numpy(),
                 "windspeed": r[1].windspeed.cpu().numpy(),
                 "winddir": r[1].winddir.cpu().numpy()}
           for lab, r in runs.items()}
    check_fields(runs["kernel"][0], runs["plain"][0], f"B1 {name} scan")
    check_fields(fin["kernel"], fin["plain"], f"B1 {name} final state",
                 bit_state=("windspeed", "winddir"))

    # the kernel alone on the last step's inputs
    params = Params()
    d = {k: torch.as_tensor(a, device=dev) for k, a in
         dict(lsm=lsm, z=z, std=std, pres=pres, theta=theta[2], u=u[2],
              v=v[2], ci=ci[2]).items()}
    cd = pipe.distance_field(d["lsm"], d["ci"])
    t0, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        d["theta"], d["u"], d["v"], cd, d["z"], d["std"], d["pres"], params,
        nn)
    ws0 = torch.full((nlat, nlon), 5.0, device=dev)
    wd0 = torch.full((nlat, nlon), 90.0, device=dev)
    is_first, upd = cadence(15, params)
    scan = StackedScan(nlat, nlon, params, dev)
    bufs = scan.init_buffers(1, ws0, wd0)
    ever = scan.add_coastal(cd)
    ws_s, wd_s = ws0.clone(), wd0.clone()

    def kernel():
        ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s,
                                  wd_s, is_first, upd, params, nn, 0, *bufs,
                                  ever)

    def plain():
        return trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                             is_first, upd, params, nn)

    kernel()
    sb, ows, owd, _, _ = plain()
    err = check_fields(
        {"sb_con": bufs[0][0].cpu(), "windspeed": bufs[1][0].cpu(),
         "winddir": bufs[2][0].cpu()},
        {"sb_con": sb.cpu(), "windspeed": ows.cpu(), "winddir": owd.cpu()},
        f"B1 {name} single step")
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    n_ever = int(ever.sum())
    log(f"# B1 ring_trigger {name} NN={nn}: 3-step scan from tt=14 matches "
        f"plain (final ws/wd bit-equal); step max |diff| {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {n_ever}/{ever.numel()} "
        f"tiles coastal; scan ms/step kernel path "
        f"{runs['kernel'][2]:.2f}, plain path {runs['plain'][2]:.2f}")
    out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_golden():
    """The port's diag on the card against the NumPy oracle: a 64 x 64
    regional world, 4 steps, sea ice appearing at step 2 (the tolerances of
    tests/test_diag_e2e.py)."""
    from bench import make_world
    from seabreeze_param_tpu_torch.api import diag
    from tests.golden.reference_numpy import golden_diag_sequence

    nlat, nlon, nt = 64, 64, 4
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 5, nt,
                                                    seed=7)
    ci[:] = 0.0
    ci[2:, :6, :] = 0.9
    lat = np.linspace(7.0, -24.5, nlat).astype(np.float32)
    lon = np.linspace(100.0, 132.0, nlon, endpoint=False).astype(np.float32)
    ref = golden_diag_sequence(nt, pres, z, std, theta, v, u, lsm, ci, lon,
                               lat)
    tt, sb, thc, ws, wd = diag(1, lsm, z, std, lon, lat, pres, u, v, theta,
                               ci, device="cuda")
    assert tt == 1 + nt
    miss_r, miss_g = ref[0] == MISSING, sb == MISSING
    if not np.array_equal(miss_r[:, :-1], miss_g[:, :-1]):
        raise AssertionError("golden: MISSING structure differs")
    sel = (~miss_r) & (np.arange(nlat)[None, :, None] < nlat - 1)
    mism = ~np.isclose(sb[sel], ref[0][sel], rtol=5e-4, atol=5e-4)
    if mism.mean() >= 2e-3:
        raise AssertionError(f"golden: sb mismatch {mism.sum()}/{mism.size}")
    np.testing.assert_allclose(thc[:-1], ref[1, -1][:-1], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ws[:-1], ref[2, -1][:-1], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(wd[:-1], ref[3, -1][:-1], rtol=1e-3,
                               atol=0.2)
    log(f"# golden 64x64 x {nt} steps: diag on the card matches the NumPy "
        f"oracle (sb mismatch {int(mism.sum())}/{mism.size})")


def main_world(T=32, nlev=4):
    """The main path's world: ``(grid, (lsm, z, std, pres, theta, u, v,
    ci))`` at global 0.25 deg, with a polar ice edge that moves one row
    every 8 steps, so the coastline changes along the scan."""
    from bench import make_world
    grid, _, _ = world_grid("global025")
    lsm, z, std, pres, theta, u, v, ci = make_world(grid.nlat, grid.nlon,
                                                    nlev, T)
    for t in range(T):
        ci[t] = 0.0
        ci[t, : grid.nlat // 12 + t // 8, :] = 0.8
    return grid, (lsm, z, std, pres, theta, u, v, ci)


def phase_main(out):
    """The main path: diag at global 0.25 deg, 32 steps, moving sea ice."""
    import torch
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_trigger_cuda_stacked)

    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    lon, lat = grid.lon, grid.lat
    T, nlat, nlon = theta.shape
    nlev = len(pres)
    args = (1, lsm, z, std, lon, lat, pres, u, v, theta, ci)

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = diag(*args, device="cuda", full_output=True, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    run()                                   # warm-up
    pass2_min_cuda.launches = 0
    ring_trigger_cuda_stacked.launches = 0
    kern, secs = run()
    launches = {"pass2_min": pass2_min_cuda.launches,
                "ring_trigger": ring_trigger_cuda_stacked.launches}
    if launches["ring_trigger"] != T:
        raise AssertionError(f"ring_trigger launched "
                             f"{launches['ring_trigger']} times, want {T}")
    if launches["pass2_min"] < T:
        raise AssertionError(f"pass2_min launched {launches['pass2_min']} "
                             f"times, want >= {T}")
    plain, plain_secs = run(use_kernels=False)
    if kern[0] != plain[0] or kern[0] != 1 + T:
        raise AssertionError("main path: tt differs")
    check_fields(kern[5], plain[5], "main path per-step outputs")
    check_fields(dict(thc=kern[2], windspeed=kern[3], winddir=kern[4]),
                 dict(thc=plain[2], windspeed=plain[3], winddir=plain[4]),
                 "main path final state", bit_state=("windspeed", "winddir"))
    sb = kern[1]
    if sb.shape != (T, nlat, nlon) or not np.isfinite(sb).all():
        raise AssertionError("main path: sb_con shape or finiteness")
    miss = float((sb == MISSING).mean())
    trig = int(((sb != MISSING) & (sb != 0)).sum())
    ms = secs / T * 1e3
    log(f"# main path diag global025 ({nlat}x{nlon}, nlev={nlev}, T={T}, "
        f"moving ice): kernel path {ms:.3f} ms/step, "
        f"{nlat * nlon * T / secs:.4g} grid-points/s (host arrays in and "
        f"out, ring probe included); plain path "
        f"{plain_secs / T * 1e3:.3f} ms/step; launches {launches}; matches "
        f"plain (final ws/wd bit-equal); sb missing fraction {miss:.4f}, "
        f"nonzero triggers {trig}")

    # the same scan with every input already on the card
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    dev = torch.device("cuda")
    d = [torch.as_tensor(a, device=dev)
         for a in (theta, u, v, lsm, z, std, pres, ci)]
    resident = {}
    for label, uk in (("kernel", None), ("plain", False)):
        pipe = TriggerPipeline(grid, device=dev, use_kernels=uk)
        for _ in range(2):                  # warm-up, then the timed run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run(TriggerState.zeros((nlat, nlon), dev), *d[:7],
                     ci_t=d[7])
            torch.cuda.synchronize()
        resident[label] = (time.perf_counter() - t0) / T * 1e3
    log(f"# main path, inputs resident on the card (TriggerPipeline.run, "
        f"NN={pipe.nn_max}): kernel path {resident['kernel']:.3f} ms/step "
        f"({nlat * nlon / resident['kernel'] * 1e3:.4g} grid-points/s), "
        f"plain path {resident['plain']:.3f} ms/step")
    out.update(launches=launches, ms_per_step=ms,
               plain_ms_per_step=plain_secs / T * 1e3,
               resident_ms_per_step=resident)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import bench  # noqa: F401  (the world generator; fails outside the repo)
    import seabreeze_param_tpu_torch.api  # noqa: F401

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    b2, b1, main_out = {}, {}, {}
    phase_build()
    for name in ("global025", "global010"):
        phase_pass2(name, b2)
        phase_ring(name, b1)
    phase_golden()
    phase_main(main_out)

    launches = main_out["launches"]
    kernels = []
    for name, src, replaces, meas in (
            ("pass2_min", "seabreeze_param_tpu_torch/csrc/pass2_min.cu",
             "seabreeze_param_tpu/ops/pallas/distance_kernel.py:233", b2),
            ("ring_trigger_stacked",
             "seabreeze_param_tpu_torch/csrc/ring_trigger.cu",
             "seabreeze_param_tpu/ops/pallas/ring_kernel.py:694", b1)):
        m = meas["global025"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name.replace("_stacked", "")],
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            shape="global025",
            global010=meas.get("global010")))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
