#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``seabreeze_param_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, checks
the port's ``diag`` against the loop-faithful NumPy oracle on a small
world, then drives ``diag`` once at global 0.25 degrees (721 x 1440, 4
levels, 32 steps, moving polar sea ice) and holds it against the plain path.
Then the per-step paths, each against its plain version: the coupling API
(``CoupledTrigger``, kernel B4, with B5 alone on the same steps), the fused
distance (``distance_impl='fused'``, kernel B3) and the dummy model.  Then
the decomposed run on a 2 x 4 mesh of the one card: the halo exchange B6
alone against its plain version at the shard shapes of 0.25 and 0.1 deg,
``ShardedPipeline.run`` for 16 steps of the main world, overlapped (B6 +
B2 + B1) against the single-device run and its own plain path, basic (B6 +
B2 + B4) against overlapped, ``diag(mesh='2x4')`` against ``diag()``, and
the dummy model's ``--sharded``.  Each path's launch counts are zeroed
just before it runs and read just after.  Any failed check raises, so the
exit code is non-zero.

Output: a line with the card's name and power limit (``nvidia-smi``), one
line per phase, a JSON line ``{"kernels": [...]}`` with each kernel's
launches on the main path, error against its plain version and times, and
as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

MISSING = np.float32(2.0e20)
BIG = np.float32(1.0e30)
#: The coupled phases' 8 steps of the main world: its ice edge moves at
#: steps 8, 16 and 24.
COUPLED_STEPS = tuple(range(0, 32, 4))
#: The decomposed phases: a 2 x 4 mesh, the main world's first 16 steps (its
#: ice edge moves once, at step 8).
SHARD_MESH, SHARD_STEPS = "2x4", 16
#: The halo exchange's (lat_fill, exact_lon) combinations on the path.
HALO_FILLS = (("clamp", True), ("clamp", False), ("zero", False))


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


@functools.cache
def main_world(T=32, nlev=4):
    """The main path's world: ``(grid, (lsm, z, std, pres, theta, u, v,
    ci))`` at global 0.25 deg, with a polar ice edge that moves one row
    every 8 steps, so the coastline changes along the scan.  Built once."""
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
    zero_launches()
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


def kernel_wrappers():
    """Name -> wrapper (whose ``launches`` counts its kernel) of every
    kernel of the port."""
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        min_haversine_param_cuda, pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import (
        halo_exchange_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_thc_cuda_padded, ring_trigger_cuda_padded,
        ring_trigger_cuda_stacked)
    return {"pass2_min": pass2_min_cuda,
            "ring_trigger_stacked": ring_trigger_cuda_stacked,
            "min_haversine": min_haversine_param_cuda,
            "ring_trigger_padded": ring_trigger_cuda_padded,
            "ring_thc": ring_thc_cuda_padded,
            "halo_exchange": halo_exchange_cuda}


def zero_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def bit_equal(got, ref, what):
    """Raise unless the tensors are equal bit for bit; return max |diff|."""
    import torch
    err = float((got.double() - ref.double()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: not bit-equal, max |diff| {err}")
    return err


def phase_padded(name, out):
    """Kernels B3, B4 (tt = 1, 5, 15) and B5 alone against their plain
    versions on one step of a real world, bit for bit, with times."""
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        min_haversine_param_cuda, pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_thc_cuda_padded, ring_trigger_cuda_padded)
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, min_haversine_param_from_padded, pad_coast,
        pass1_extrema)
    from seabreeze_param_tpu_torch.ops.ring_search import (
        ring_quantities, ring_thc_from_padded)
    from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                       trigger_cells)

    grid, _, _ = world_grid(name)
    nlat, nlon = GRIDS[name]
    dev = torch.device("cuda")
    world = make_world(nlat, nlon, 4, 1, seed=3)
    lsm, z, std, pres, theta, u, v, ci = (torch.as_tensor(a, device=dev)
                                          for a in world)
    params = Params()
    pipe = TriggerPipeline(grid, device=dev)
    k, nn = pipe.k, pipe.nn_max
    res = {}

    # B3: both passes fused, against its plain version and the hybrid
    tabs = device_tables(grid, k, dev)
    cpad = pad_coast(get_edges(lsm, ci[0]), k)
    err = bit_equal(min_haversine_param_cuda(cpad, *tabs, k),
                    min_haversine_param_from_padded(cpad, *tabs, k),
                    f"B3 {name}")
    res["min_haversine"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: min_haversine_param_cuda(cpad, *tabs, k)),
        plain_ms=cuda_ms(
            lambda: min_haversine_param_from_padded(cpad, *tabs, k)),
        hybrid_ms=cuda_ms(lambda: pass2_min_cuda(
            pass1_extrema(cpad, tabs[2], k), tabs[0], tabs[1], k)))

    # B4 at seeding, a plain step and a refresh; B5 on the same step
    cd = pipe.distance_field(lsm, ci[0])
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        theta[0], u[0], v[0], cd, z, std, pres, params, nn)
    rng = np.random.default_rng(1)
    ws0 = torch.as_tensor((5 + rng.random((nlat, nlon))).astype(np.float32),
                          device=dev)
    wd0 = torch.as_tensor(
        (360 * rng.random((nlat, nlon)) - 180).astype(np.float32), device=dev)
    err = 0.0
    for tt in (1, 5, 15):
        flags = cadence(tt, params)
        b4_args = (t0_pad, cd_pad, cd, ws_new, wd_new, ws0, wd0, *flags,
                   params, nn)
        got = ring_trigger_cuda_padded(*b4_args)
        ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                            *flags, params, nn)
        for g, r, f in zip(got, (ref[0], ref[3], ref[4]), ("sb", "ws", "wd")):
            err = max(err, bit_equal(g, r, f"B4 {name} tt={tt} {f}"))
    res["ring_trigger_padded"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ring_trigger_cuda_padded(
            *b4_args)),
        plain_ms=cuda_ms(lambda: trigger_cells(
            cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad, *flags, params,
            nn)))

    coastal = cd.abs() <= float(np.float32(params.maxdist))
    mul = torch.where(cd >= 0, 1.0, -1.0)

    def b5_plain():
        return ring_thc_from_padded(ring_quantities(t0_pad, cd_pad), mul, nn,
                                    coastal=coastal)[0]

    err = bit_equal(ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn), b5_plain(),
                    f"B5 {name}")
    res["ring_thc"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)),
        plain_ms=cuda_ms(b5_plain))
    log(f"# B3/B4/B5 {name} k={k} NN={nn}: bit-equal to plain (B4 at "
        f"tt=1/5/15); ms kernel vs plain: " + "; ".join(
            f"{n} {m['ms']:.4f} vs {m['plain_ms']:.4f}"
            for n, m in res.items())
        + f"; hybrid distance {res['min_haversine']['hybrid_ms']:.4f}")
    out[name] = res


def coupled_inputs(dev):
    """The coupled phases' inputs on the card: the main world's 8
    :data:`COUPLED_STEPS` and a 3-D pressure on its 4 levels, perturbed
    per column so the nearest level differs across the grid."""
    import torch
    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    sel = list(COUPLED_STEPS)
    rng = np.random.default_rng(5)
    p3 = (pres[:, None, None] * (1.0 + 0.3 * rng.random(
        (1,) + lsm.shape))).astype(np.float32)
    d = {k: torch.as_tensor(a, device=dev) for k, a in dict(
        lsm=lsm, z=z, std=std, pres=pres, p3=p3, theta=theta[sel],
        u=u[sel], v=v[sel], ci=ci[sel]).items()}
    return grid, d


def final_fields(state):
    return {"thc": state.thc.cpu(), "windspeed": state.windspeed.cpu(),
            "winddir": state.winddir.cpu()}


def phase_coupling(out):
    """The per-step coupling path at global 0.25 deg: 8 steps of
    ``CoupledTrigger.prepare_mask`` + ``physics`` (3-D pressure, moving
    ice), kernel path against ``use_kernels=False``.  Then B5 on the same
    steps, the ring search alone, held to the trigger rule."""
    import torch
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.coupling import CoupledTrigger
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_thc_cuda_padded)
    from seabreeze_param_tpu_torch.ops.trigger import prepare_step

    dev = torch.device("cuda")
    grid, d = coupled_inputs(dev)
    nlat, nlon = grid.shape
    S = len(COUPLED_STEPS)

    def drive(uk):
        ct = CoupledTrigger(grid, use_kernels=uk, device=dev)
        state = TriggerState.zeros((nlat, nlon), dev)
        outs, masks = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(S):
            cd = ct.prepare_mask(d["lsm"], d["ci"][s])
            state, o = ct.physics(state, d["p3"], d["u"][s], d["v"][s],
                                  d["theta"][s], d["z"], d["std"], cd)
            outs.append(o)
            masks.append(cd)
        torch.cuda.synchronize()
        return state, outs, masks, (time.perf_counter() - t0) / S * 1e3

    drive(None)                                 # warm-up
    zero_launches()
    kstate, kouts, masks, kms = drive(None)
    launches = read_launches()
    if launches["ring_trigger_padded"] != S or launches["pass2_min"] != S:
        raise AssertionError(f"coupling launches {launches}, want B4 and "
                             f"B2 {S} times each")
    pstate, pouts, _, pms = drive(False)
    if read_launches() != launches:
        raise AssertionError("coupling: the plain path launched a kernel")
    worst = 0.0
    for s, (ko, po) in enumerate(zip(kouts, pouts)):
        worst = max(worst, check_fields(
            {k: o.cpu() for k, o in ko.items()},
            {k: o.cpu() for k, o in po.items()}, f"coupling step {s}"))
    check_fields(final_fields(kstate), final_fields(pstate),
                 "coupling final state", bit_state=("windspeed", "winddir"))
    sb = torch.stack([o["sb_con"] for o in kouts])
    if sb.shape != (S, nlat, nlon) or not torch.isfinite(sb).all():
        raise AssertionError("coupling: sb_con shape or finiteness")
    trig = (sb != float(MISSING)) & (sb != 0)

    # B5 on the coupled steps: the ring search alone, as a diagnostic.  A
    # cell triggers only where |n_thc| > thresh_thc, and n_thc is zero off
    # the coastal band.
    params = Params()
    nn = CoupledTrigger(grid, device=dev).pipeline().nn_max
    pads = [prepare_step(d["theta"][s], d["u"][s], d["v"][s], masks[s],
                         d["z"], d["std"], d["p3"], params, nn)[3:]
            for s in range(S)]
    zero_launches()
    n_thc = torch.stack([ring_thc_cuda_padded(*pads[s], masks[s], nn)
                         for s in range(S)])
    b5 = read_launches()["ring_thc"]
    if b5 != S:
        raise AssertionError(f"ring_thc launched {b5} times, want {S}")
    band = torch.stack(masks).abs() <= float(np.float32(params.maxdist))
    if (n_thc[~band] != 0).any() or not torch.isfinite(n_thc).all():
        raise AssertionError("B5: n_thc nonzero off the band or not finite")
    if (n_thc[trig].abs() <= float(np.float32(params.thresh_thc))).any():
        raise AssertionError("B5: a triggered cell has |n_thc| <= thresh")
    log(f"# coupling global025 ({nlat}x{nlon}, 3-D pressure on 4 levels, "
        f"{S} steps, moving ice): prepare_mask + physics kernel path "
        f"{kms:.3f} ms/step, plain path {pms:.3f} ms/step; launches "
        f"{launches}; matches plain (step max |diff| {worst:.3g}, final "
        f"ws/wd bit-equal); {int(trig.sum())} triggers; B5 over the same "
        f"steps: {b5} launches, zero off the band, |n_thc| > thresh at "
        f"every trigger")
    out.update(launches=launches, b5_launches=b5, ms_per_step=kms,
               plain_ms_per_step=pms)


def phase_fused(out):
    """``TriggerPipeline(distance_impl='fused').run`` (B3 + B1) for the 8
    coupled steps against the default pipeline (B2 + B1)."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline

    dev = torch.device("cuda")
    grid, d = coupled_inputs(dev)
    nlat, nlon = grid.shape
    S = len(COUPLED_STEPS)
    fused = TriggerPipeline(grid, device=dev, distance_impl="fused")
    default = TriggerPipeline(grid, device=dev)
    bit_equal(fused.distance_field(d["lsm"], d["ci"][0]),
              default.distance_field(d["lsm"], d["ci"][0]),
              "fused distance, first step")

    def run(pipe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pipe.run(TriggerState.zeros((nlat, nlon), dev), d["theta"],
                     d["u"], d["v"], d["lsm"], d["z"], d["std"], d["pres"],
                     ci_t=d["ci"])
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / S * 1e3

    run(fused)                                  # warm-up
    zero_launches()
    (fstate, fouts), fms = run(fused)
    launches = read_launches()
    if (launches["min_haversine"] != S
            or launches["ring_trigger_stacked"] != S
            or launches["pass2_min"] != 0):
        raise AssertionError(f"fused launches {launches}, want B3 and B1 "
                             f"{S} times each, B2 none")
    (dstate, douts), dms = run(default)
    worst = check_fields({k: o.cpu() for k, o in fouts.items()},
                         {k: o.cpu() for k, o in douts.items()},
                         "fused run per-step outputs")
    check_fields(final_fields(fstate), final_fields(dstate),
                 "fused run final state", bit_state=("windspeed", "winddir"))
    log(f"# fused distance global025 ({S} steps, moving ice): first cdist "
        f"bit-equal to the default pipeline's; run ms/step fused (B3+B1) "
        f"{fms:.3f}, default (B2+B1) {dms:.3f}; launches {launches}; "
        f"outputs match (max |diff| {worst:.3g}, final ws/wd bit-equal)")
    out.update(launches=launches, ms_per_step=fms,
               default_ms_per_step=dms)


def phase_dummy(out):
    """The port's dummy model, 12 coupled steps on the card, kernel path
    against plain."""
    import torch
    from seabreeze_param_tpu_torch.examples import dummy_model

    steps = 12
    dummy_model.run(steps=2)                    # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kfin, ksb = dummy_model.run(steps=steps)
    torch.cuda.synchronize()
    kms = (time.perf_counter() - t0) / steps * 1e3
    launches = read_launches()
    if (launches["ring_trigger_padded"] != steps
            or launches["pass2_min"] != steps):
        raise AssertionError(f"dummy model launches {launches}")
    pfin, psb = dummy_model.run(steps=steps, use_kernels=False)
    shape = (steps, dummy_model.NY, dummy_model.NX)
    if ksb.shape != shape or not torch.isfinite(ksb).all():
        raise AssertionError("dummy model: sb_con shape or finiteness")
    worst = check_fields({"sb_con": ksb.cpu()}, {"sb_con": psb.cpu()},
                         "dummy model sb_con")
    check_fields(final_fields(kfin), final_fields(pfin),
                 "dummy model final state",
                 bit_state=("windspeed", "winddir"))
    if kfin.tt != steps + 1:
        raise AssertionError(f"dummy model: tt {kfin.tt}")
    active = ksb[ksb < 1.0e19]
    log(f"# dummy model ({dummy_model.NY}x{dummy_model.NX}, {steps} steps): "
        f"kernel path {kms:.3f} ms/step; launches {launches}; matches plain "
        f"(max |diff| {worst:.3g}, final ws/wd bit-equal); "
        f"{int((active != 0).sum())} active triggers")
    out.update(launches=launches, ms_per_step=kms)


def shard_mesh_and_shape(name):
    """The 2 x 4 mesh on the card and the (h, w) shard of grid ``name``
    (lat replication-padded to a multiple of the mesh rows)."""
    import torch
    from bench import GRIDS
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(SHARD_MESH, torch.device("cuda"))
    nlat, nlon = GRIDS[name]
    return mesh, (-(-nlat // mesh.py), nlon // mesh.px)


def phase_halo(name, out):
    """Kernel B6 alone against its plain version, bit for bit, on random
    2 x 4 shards of grid ``name``: widths 1, k, NN and NN+k+1 (the path's
    exchanges) in each fill, and the 2-channel ring inputs at NN."""
    import torch
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import (
        halo_exchange_cuda)
    from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain

    grid, _, _ = world_grid(name)
    dev = torch.device("cuda")
    mesh, (h, w) = shard_mesh_and_shape(name)
    pipe = TriggerPipeline(grid, device=dev)
    k, nn = pipe.k, pipe.nn_max
    gen = torch.Generator(device=dev).manual_seed(4)
    one = [torch.randn((h, w), generator=gen, device=dev)
           for _ in range(mesh.size)]
    two = [torch.randn((2, h, w), generator=gen, device=dev)
           for _ in range(mesh.size)]
    rows = {}
    for local, widths in ((one, (1, k, nn, nn + k + 1)), (two, (nn,))):
        for width in widths:
            for fill, exact in HALO_FILLS:
                kw = dict(lat_fill=fill, exact_lon=exact)

                def kernel():
                    return halo_exchange_cuda(local, mesh, width, width, **kw)

                def plain():
                    return halo_exchange_plain(local, mesh, width, width,
                                               **kw)

                tag = (f"C={local[0].dim() - 1} w={width} {fill}"
                       f"{' exact' if exact else ''}")
                for s, (g, r) in enumerate(zip(kernel(), plain())):
                    bit_equal(g, r, f"B6 {name} {tag} shard {s}")
                rows[tag] = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain))
    ref = rows[f"C=1 w={nn} clamp"]          # theta's exchange, every step
    log(f"# B6 halo_exchange {name} on {SHARD_MESH} ({h}x{w} shards, k={k} "
        f"NN={nn}): bit-equal to plain at every width and fill; ms kernel "
        f"vs plain: " + "; ".join(f"{t} {m['ms']:.4f} vs {m['plain_ms']:.4f}"
                                   for t, m in rows.items()))
    out[name] = dict(max_abs_err=0.0, ms=ref["ms"], plain_ms=ref["plain_ms"],
                     shard=[h, w], widths=rows)


def outputs_sharded_close(got, ref, what):
    """``tests/test_sharded.py``'s sharded tolerance: MISSING structure
    equal, then rtol 1e-5 / atol 1e-4 with under 1e-3 of cells off;
    returns the largest fraction off."""
    worst = 0.0
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        miss = r == MISSING
        if g.shape != r.shape or not np.array_equal(g == MISSING, miss):
            raise AssertionError(f"{what}: {key} shape or MISSING structure")
        off = float((~np.isclose(g[~miss], r[~miss], rtol=1e-5,
                                 atol=1e-4)).mean())
        if off >= 1e-3:
            raise AssertionError(f"{what}: {key} {off:.3g} of cells off")
        worst = max(worst, off)
    return worst


def phase_sharded(out):
    """The decomposed run at global 0.25 deg on a 2 x 4 mesh of the card,
    16 steps of the main world: overlapped on the kernel path (B6 + B2 +
    B1) against the single-device kernel run (sharded tolerance) and its
    own plain path (final wind bit-equal), then basic (B6 + B2 + B4)
    bit-equal to overlapped."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    dev = torch.device("cuda")
    grid, world = main_world()
    lsm, z, std, pres, theta, u, v, ci = world
    T = SHARD_STEPS
    nlat, nlon = grid.shape
    d = [torch.as_tensor(a, device=dev) for a in
         (theta[:T], u[:T], v[:T], lsm, z, std, pres, ci[:T])]
    mesh, _ = shard_mesh_and_shape("global025")
    single = TriggerPipeline(grid, device=dev)
    plain_pipe = TriggerPipeline(grid, device=dev, use_kernels=False)
    runners = {"overlap": ShardedPipeline(single, mesh),
               "basic": ShardedPipeline(single, mesh, overlap=False),
               "plain": ShardedPipeline(plain_pipe, mesh),
               "single": single}
    if not runners["overlap"].overlap or runners["plain"].overlap is not True:
        raise AssertionError("sharded: the overlapped structure was not "
                             "chosen at global025 on 2x4")

    def run(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, o = runners[label].run(TriggerState.zeros((nlat, nlon), dev),
                                   *d[:7], ci_t=d[7])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / T * 1e3
        return ({k: x.cpu().numpy() for k, x in o.items()}, final_fields(st),
                ms)

    nn, k = single.nn_max, single.k
    want = {"overlap": {"halo_exchange": 3 + 2 * T,
                        "ring_trigger_stacked": mesh.size * T,
                        "pass2_min": mesh.size * T},
            "basic": {"halo_exchange": 3 * T,
                      "ring_trigger_padded": mesh.size * T,
                      "pass2_min": mesh.size * T}}
    res, launches = {}, {}
    for label in ("overlap", "basic", "plain", "single"):
        run(label)                                  # warm-up
        zero_launches()
        res[label] = run(label)
        launches[label] = {n: c for n, c in read_launches().items() if c}
        if label in want and launches[label] != want[label]:
            raise AssertionError(f"sharded {label}: launches "
                                 f"{launches[label]}, want {want[label]}")
    if any(launches["plain"].values()):
        raise AssertionError(f"sharded plain path launched a kernel: "
                             f"{launches['plain']}")
    ov, ba, pl, sg = (res[x] for x in ("overlap", "basic", "plain", "single"))
    off = outputs_sharded_close(ov[0], sg[0], "sharded vs single device")
    np.testing.assert_allclose(ov[1]["thc"], sg[1]["thc"], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(ov[1]["windspeed"], sg[1]["windspeed"],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ov[1]["winddir"], sg[1]["winddir"], rtol=1e-5,
                               atol=1e-3)
    worst = check_fields(ov[0], pl[0], "sharded kernel vs plain path")
    check_fields(ov[1], pl[1], "sharded final state",
                 bit_state=("windspeed", "winddir"))
    for key in ov[0]:
        if not np.array_equal(ov[0][key], ba[0][key]):
            raise AssertionError(f"sharded basic vs overlapped: {key}")
    for key in ov[1]:
        if not torch.equal(ov[1][key], ba[1][key]):
            raise AssertionError(f"sharded basic vs overlapped state: {key}")
    sb = ov[0]["sb_con"]
    if sb.shape != (T, nlat, nlon) or not np.isfinite(sb).all():
        raise AssertionError("sharded: sb_con shape or finiteness")
    log(f"# sharded global025 on {SHARD_MESH} (T={T}, k={k}, NN={nn}, moving "
        f"ice), ShardedPipeline.run with inputs resident, ms/step: "
        f"overlapped kernel path {ov[2]:.3f}, basic kernel path "
        f"{ba[2]:.3f}, overlapped plain path {pl[2]:.3f}, single-device "
        f"kernel run {sg[2]:.3f}; launches {launches['overlap']} "
        f"(overlapped), {launches['basic']} (basic); matches the single "
        f"device (largest fraction off {off:.3g}) and the plain path (max "
        f"|diff| {worst:.3g}, final ws/wd bit-equal); basic bit-equal to "
        f"overlapped")
    out.update(launches=launches, ms_per_step={x: res[x][2] for x in res})


def phase_diag_mesh(out):
    """``diag(mesh='2x4')`` with host arrays against ``diag()`` in the same
    call, 16 steps of the main world."""
    import torch
    from seabreeze_param_tpu_torch.api import diag

    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    T = SHARD_STEPS
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u[:T], v[:T],
            theta[:T], ci[:T])

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = diag(*args, device="cuda", full_output=True, **kw)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / T * 1e3

    run(mesh=SHARD_MESH)                             # warm-up
    zero_launches()
    meshed, mms = run(mesh=SHARD_MESH)
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"halo_exchange": 3 + 2 * T, "ring_trigger_stacked": 8 * T,
            "pass2_min": 8 * T + 1}                 # + the ring probe
    if launches != want:
        raise AssertionError(f"diag mesh launches {launches}, want {want}")
    run()                                            # warm-up
    single, sms = run()
    if meshed[0] != single[0] or meshed[0] != 1 + T:
        raise AssertionError("diag mesh: tt differs")
    off = outputs_sharded_close(meshed[5], single[5], "diag mesh vs diag")
    log(f"# diag(mesh='{SHARD_MESH}') global025 T={T}, host arrays: "
        f"{mms:.3f} ms/step, diag() {sms:.3f} ms/step in the same call; "
        f"launches {launches}; matches diag() (largest fraction off "
        f"{off:.3g})")
    out.update(launches=launches, ms_per_step=mms, single_ms_per_step=sms)


def phase_dummy_sharded(out):
    """The dummy model's ``--sharded --mesh=2x4`` (static coastline,
    overlapped), kernel path against plain."""
    import torch
    from seabreeze_param_tpu_torch.examples import dummy_model

    steps, dev = 12, "cuda"
    dummy_model.main([f"--steps={steps}", f"--device={dev}", "--sharded",
                      f"--mesh={SHARD_MESH}"])      # the CLI, and warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kfin, ksb = dummy_model.run(steps=steps, sharded=True, mesh=SHARD_MESH,
                                device=dev)
    torch.cuda.synchronize()
    kms = (time.perf_counter() - t0) / steps * 1e3
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"halo_exchange": 4 + steps, "ring_trigger_stacked": 8 * steps,
            "pass2_min": 8}
    if launches != want:
        raise AssertionError(f"dummy sharded launches {launches}, want "
                             f"{want}")
    pfin, psb = dummy_model.run(steps=steps, sharded=True, mesh=SHARD_MESH,
                                device=dev, use_kernels=False)
    if ksb.shape != (steps, dummy_model.NY, dummy_model.NX) or not \
            torch.isfinite(ksb).all():
        raise AssertionError("dummy sharded: sb_con shape or finiteness")
    worst = check_fields({"sb_con": ksb.cpu()}, {"sb_con": psb.cpu()},
                         "dummy sharded sb_con")
    check_fields(final_fields(kfin), final_fields(pfin),
                 "dummy sharded final state",
                 bit_state=("windspeed", "winddir"))
    log(f"# dummy model --sharded --mesh={SHARD_MESH} ({steps} steps): "
        f"kernel path {kms:.3f} ms/step; launches {launches}; matches plain "
        f"(max |diff| {worst:.3g}, final ws/wd bit-equal)")
    out.update(launches=launches, ms_per_step=kms)


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

    b2, b1, padded, main_out = {}, {}, {}, {}
    coupling, fused, dummy = {}, {}, {}
    b6, sharded, diag_mesh, dummy_sharded = {}, {}, {}, {}
    phase_build()
    for name in ("global025", "global010"):
        phase_pass2(name, b2)
        phase_ring(name, b1)
        phase_padded(name, padded)
        phase_halo(name, b6)
    phase_golden()
    phase_main(main_out)
    phase_coupling(coupling)
    phase_fused(fused)
    phase_dummy(dummy)
    phase_sharded(sharded)
    phase_diag_mesh(diag_mesh)
    phase_dummy_sharded(dummy_sharded)

    def per_kernel(name):
        return {g: padded[g][name] for g in padded}

    src = "seabreeze_param_tpu_torch/csrc/"
    pal = "seabreeze_param_tpu/ops/pallas/"
    kernels = []
    for name, cu, replaces, meas, launches, path in (
            ("pass2_min", "pass2_min.cu", "distance_kernel.py:233", b2,
             main_out["launches"]["pass2_min"], "main path: diag"),
            ("ring_trigger_stacked", "ring_trigger.cu", "ring_kernel.py:694",
             b1, main_out["launches"]["ring_trigger"], "main path: diag"),
            ("min_haversine", "min_haversine.cu", "distance_kernel.py:93",
             per_kernel("min_haversine"),
             fused["launches"]["min_haversine"],
             "TriggerPipeline(distance_impl='fused').run"),
            ("ring_trigger_padded", "ring_trigger.cu", "ring_kernel.py:837",
             per_kernel("ring_trigger_padded"),
             coupling["launches"]["ring_trigger_padded"],
             "coupling: CoupledTrigger.physics"),
            ("ring_thc", "ring_trigger.cu", "ring_kernel.py:194",
             per_kernel("ring_thc"), coupling["b5_launches"],
             "standalone op on the coupled steps"),
            ("halo_exchange", "halo_exchange.cu", "halo_kernel.py:183", b6,
             sharded["launches"]["overlap"]["halo_exchange"],
             f"sharded: ShardedPipeline.run on {SHARD_MESH}, overlapped")):
        m = meas["global025"]
        kernels.append(dict(
            name=name, route="cuda", source=src + cu, replaces=pal + replaces,
            launches=launches, max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], shape="global025", path=path,
            global010=meas.get("global010")))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
