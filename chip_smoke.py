#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``seabreeze_param_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card and
times it (device time with the L2 flushed, a caller's time, the plain
version's, the least time the card could take, and one library call's
where there is one), checks the port's ``diag`` against the
loop-faithful NumPy oracle on a small world, then drives ``diag`` once at
global 0.25 degrees (721 x 1440, 4 levels, 32 steps, moving polar sea ice)
and holds it against the plain path.  Then the per-step paths, each
against its plain version: the coupling API (``CoupledTrigger``, kernel
B4, with B5 alone on the same steps), the two distances of
``TriggerPipeline.run`` against each other (``'fused'``, kernel B3, the
card's default, and ``'hybrid'``, torch pass 1 + kernel B2) and the dummy
model.  Then two kilometre-scale regional worlds (1024 x 1024 at 0.015
and at 0.009 deg, whose ring radii take the large build of B1, B4 and B5
and whose distance radii, k = 93 and 155, the first design of B3
refused): ``diag`` (and at 0.015 deg the coupled step) against their
plain paths, B1's large build timed, the fused distance bit-equal to the
hybrid's and B3 timed beside the hybrid.  Then the decomposed run on a 2
x 4 mesh of the one card: the halo exchange B6 alone against its plain
version at the shard shapes of 0.25 and 0.1 deg, ``ShardedPipeline.run``
for 16 steps of the main world, overlapped (B6 + B3 + B1) against the
single-device run and its own plain path, basic (B6 + B3 + B4) against
overlapped, ``diag(mesh='2x4')`` against ``diag()``, and the dummy
model's ``--sharded``.  Then one mesh spread over several cards
(:func:`phase_multicard`): 2 x 2 shards of global 0.1 deg over up to four
cards, or over four groups of the one card, bit-equal to the one-group
mesh, with B6 timed over the groups; it says whether the peer path across
cards was shown.  Last the batch driver (``cli/run.py``) over a
daily netCDF series of the main world written into a temporary directory
(3 files of 4 steps): kernel path against plain, bit-equal to the same
``diag`` calls on the in-memory arrays, ``--mesh=2x4`` against the single
device, a resume from a checkpoint bit-equal to the unbroken run, the
native reader in use, and the composites.  Each path's launch counts are
zeroed just before it runs and read just after; the distance kernel they
expect is the one the package's ``'auto'`` takes on the card
(:func:`dist_kernel`).  Any failed check raises, so the exit code is
non-zero.

Output: a line with the card's name and power limit (``nvidia-smi``), one
line per phase, a JSON line ``{"kernels": [...]}`` with each kernel's
launches on its path, error against its plain version, times, bound and
share of the bound at 0.25 deg (0.1 deg under ``global010``; the large
build and B3 at the fine and 1 km worlds under ``fine`` and ``km``), and
as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import os
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
#: The driver phase's series: the main world's first 12 steps as 3 daily
#: files of 4 six-hourly steps (its ice edge moves at step 8, in file 3).
DRIVER_DAYS, DRIVER_STEPS = 3, 4
#: The fine regional world: FINE_N x FINE_N cells FINE_SPACING degrees
#: apart from 55 N southward, FINE_STEPS steps on 4 levels.
FINE_N, FINE_SPACING, FINE_STEPS = 1024, 0.015, 8
#: The 1 km world: FINE_N x FINE_N cells KM_SPACING degrees apart from 54 N
#: southward, KM_STEPS steps.
KM_SPACING, KM_STEPS = 0.009, 4
#: The wide-radius phase: FINE_N x FINE_N worlds from 54 N at these (k,
#: spacing in degrees), WIDE_STEPS steps: a 0.4 km grid (k = 387) and k =
#: 620, both past the widest radius of B3's shared-memory builds (354) and
#: of B2's staged build (175).
WIDE_WORLDS, WIDE_STEPS = ((387, 0.0036), (620, 0.00225)), 2
#: The multi-process phase: ranks over gloo sharing the one card, and the
#: seconds each launch of them may take.
MP_RANKS, MP_TIMEOUT = 2, 480
#: The ranks' grouped blocks: each rank's block of these global meshes over
#: MP_GROUPS groups of the one card (2 x 4: a 1 x 4 block, one mesh row
#: across both groups; 4 x 2: a 2 x 2 block, a mesh row each), and the
#: calls of B6's exchange with the trade that are timed together.
MP_GROUP_MESHES, MP_GROUPS, MP_TRADES = ("2x4", "4x2"), 2, 20
#: B2's two-extremum form alone: the radii it is held bit-equal at (the
#: main world's 6 and 0.1 deg's 15, its staged build's widest
#: (``pass2_min_two_limits``) and one past, the shared-memory limit of that
#: build, 93, and one past, and 387 on the pruned build), those timed, and
#: the seed of its po drawn from [-1, 1].
TWO_RADII, TWO_TIMED, TWO_SEED = (0, 6, 15, 93, 94, 387), (6, 93, 387), 17
#: Ring radii past the exact float32 land counts: B1, B4 and B5 alone at
#: these NN on a PAST_FIELD field whose cells are all land within maxdist
#: (no window holds both classes, so every cell runs to NN); then ``diag``
#: on a STRIP world, 32 x 2200 cells 0.009 deg apart from 54 N, with
#: maxdist = STRIP_MAXDIST km: k = 2200, NN = 2204, STRIP_STEPS steps.
PAST_NN, PAST_FIELD = (2048, 2204), (64, 128)
STRIP_SHAPE, STRIP_MAXDIST, STRIP_STEPS = (32, 2200), 3000.0, 2


def log(msg):
    print(msg, flush=True)


def call_ms(fn, reps=20):
    """Mean time of one call of ``fn`` in ms as a caller pays it: CUDA
    events around ``reps`` back-to-back calls, after one warm-up call.
    Where the host enqueues more slowly than the device runs, this is the
    host's time."""
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


@functools.cache
def _l2_flusher():
    """128 MB on the card, more than its 50 MB of L2."""
    import torch
    return torch.zeros(32 << 20, dtype=torch.int32, device="cuda")


def device_ms(fn, reps=20, flush=True):
    """Mean device time of one call of ``fn`` in ms, after a warm-up call:
    CUDA events around each call, queued behind a device-side wait
    (``torch.cuda._sleep``) longer than the host takes to queue the call,
    so the device finds the call's launches waiting and the events time
    the device alone.  A call the device caught up with (its start event
    already passed once it is queued) is timed again behind a longer wait.
    With ``flush`` the L2 cache is flushed before each call (128 MB
    rewritten), so inputs come from device memory, as the bound counts
    them; ``flush="read"`` flushes by reading the 128 MB instead, so the
    call finds no dirty lines to write back."""
    import torch
    l2 = _l2_flusher()
    fn()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
        torch.cuda.synchronize()
    cycles = int(max(2 * host, 5e-5) * 2e9)        # ~2 GHz clock
    pairs = []
    for _ in range(reps):
        for _ in range(6):
            if flush == "read":
                l2.sum()
            elif flush:
                l2.bitwise_not_()
            torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if not start.query():
                break
            cycles *= 2
        else:
            raise AssertionError("device_ms: the host never got ahead")
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


#: Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
#: memory in bytes/s, float32 outside the tensor cores in operations/s, and
#: its host link (PCIe 5.0 x16) in bytes/s each way.
PEAK_BYTES, PEAK_F32, PEAK_HOST_LINK = 3.35e12, 67e12, 64e9
#: float32 additions a second: PEAK_F32 counts an FMA as two operations,
#: and an addition issues at the FMA's rate, so half of it.
PEAK_F32_ADD = PEAK_F32 / 2


def timing(kernel, plain, nbytes, ops, *, library=None, library_note=None,
           plain_queued=False):
    """A kernel's times beside its bound: ``device_ms``, ``call_ms``, the
    plain version's device time, the least time the card could take
    (``bound_ms``: the larger of ``nbytes`` over the memory rate and
    ``ops`` over the float32 rate, ``bound_by`` saying which) and its share
    of the device time, and the one library call's device time
    (``library``, else null with ``library_note`` saying why).  With
    ``plain_queued`` the plain version is timed by :func:`call_ms`: it
    launches more kernels than the card queues (~1000), so the host cannot
    get ahead of the device and ``device_ms`` cannot run; the device is
    then busy throughout and the events time it."""
    dev = device_ms(kernel)
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    bound_ms = max(by_bytes, by_ops)
    return dict(
        device_ms=dev, call_ms=call_ms(kernel),
        plain_ms=call_ms(plain, reps=3) if plain_queued
        else device_ms(plain, reps=5), bound_ms=bound_ms,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        share_of_bound=bound_ms / dev, bytes=int(nbytes), ops=int(ops),
        library_ms=None if library is None else device_ms(library),
        library=library_note)


#: The bound's unit of B1's work: the tile of the parent design, so that
#: every design of B1 is held to the same bound.
BOUND_TILE = (16, 32)
#: Float32 additions per cell and radius of the ring search: three
#: channels, four window terms and the two running sums' two terms each.
RING_ADDS = 3 * (4 + 2 + 2)


#: The widest ring radius whose land counts are exact in float32: the
#: window's cell count, (2 NN + 1)^2, passes 2^24 past it.
EXACT_NN = 2047


def latch_radius(cd_pad, cd, nn, maxdist):
    """(h, w) int32: the radius at which each coastal cell latches (the
    first nn whose window holds land and sea, else NN), 0 off the band;
    from box counts of land over an integral image, and past
    :data:`EXACT_NN` from the float32 running count the plain version
    carries (each radius adding the window's new top and bottom rows and
    left and right columns, then the sea count as the cell count, rounded
    to float32, less it)."""
    import torch
    import torch.nn.functional as F
    h, w = cd.shape
    land = (cd_pad >= 0).to(torch.int32)
    ii = F.pad(land.cumsum(0).cumsum(1), (1, 0, 1, 0))

    def box(y0, x0, y1, x1):
        """Land cells of rows nn+y0..nn+y1, columns nn+x0..nn+x1 about
        each cell."""
        a, b, c, d = nn + y0, nn + y1 + 1, nn + x0, nn + x1 + 1
        return (ii[b:b + h, d:d + w] - ii[a:a + h, d:d + w]
                - ii[b:b + h, c:c + w] + ii[a:a + h, c:c + w])

    r = torch.full((h, w), nn, dtype=torch.int32, device=cd.device)
    done = torch.zeros((h, w), dtype=torch.bool, device=cd.device)
    n_l = None
    for m in range(1, nn + 1):
        if m <= EXACT_NN:
            cnt = box(-m, -m, m, m)
            ok = (cnt > 0) & (cnt < (2 * m + 1) ** 2)
            if m == EXACT_NN:
                n_l = cnt.to(torch.float32)
        else:
            for part in (box(-m, -m, -m, m), box(m, -m, m, m),
                         box(1 - m, -m, m - 1, -m), box(1 - m, m, m - 1, m)):
                n_l = n_l + part.to(torch.float32)
            n_s = float(np.float32((2 * m + 1) ** 2)) - n_l
            ok = (n_l > 0) & (n_s > 0)
        r = torch.where(ok & ~done, m, r)
        done |= ok
    return torch.where(cd.abs() <= float(np.float32(maxdist)), r, 0)


def ring_work(cd_pad, cd, nn, maxdist, ever=None, tile=BOUND_TILE):
    """B1's work on one step, in units of ``tile``: ``(tiles, cells,
    adds)`` — the tiles that run (``ever``: the ever-coastal set as a
    (ni*nj,) mask at ``tile``; None: the tiles holding a coastal cell), the
    field's cells inside them, and the ring additions those tiles need, each
    running the radii of its slowest coastal cell."""
    import torch
    import torch.nn.functional as F
    th, tw = tile
    h, w = cd.shape
    ni, nj = -(-h // th), -(-w // tw)
    r = F.pad(latch_radius(cd_pad, cd, nn, maxdist), (0, nj * tw - w,
                                                      0, ni * th - h))
    inside = F.pad(torch.ones_like(cd, dtype=torch.int32),
                   (0, nj * tw - w, 0, ni * th - h))
    radii = r.reshape(ni, th, nj, tw).amax(dim=(1, 3)).reshape(-1)
    cells = inside.reshape(ni, th, nj, tw).sum(dim=(1, 3)).reshape(-1)
    run = radii > 0 if ever is None else ever.bool()
    return (int(run.sum()), int(cells[run].sum()),
            int((cells * radii)[run].sum()) * RING_ADDS)


def tile_mask(cd, maxdist, tile=BOUND_TILE):
    """(ni*nj,) uint8: the tiles of ``tile`` that hold a coastal cell."""
    import torch
    import torch.nn.functional as F
    th, tw = tile
    h, w = cd.shape
    ni, nj = -(-h // th), -(-w // tw)
    c = (cd.abs() <= float(np.float32(maxdist))).to(torch.uint8)
    c = F.pad(c, (0, nj * tw - w, 0, ni * th - h))
    return c.reshape(ni, th, nj, tw).amax(dim=(1, 3)).reshape(-1)


def fmt_timing(t):
    lib = ("" if t["library_ms"] is None
           else f", library {t['library_ms']:.4f}")
    return (f"device {t['device_ms']:.4f} ms, call {t['call_ms']:.4f}, "
            f"plain {t['plain_ms']:.4f}{lib}; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), share {t['share_of_bound']:.3f}")


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
        if any(s in line for s in ("registers", "Compiling entry", "spill")):
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
    Mmin, _ = pass1_extrema(pad_coast(coast, k), sdlam2, k)
    got = pass2_min_cuda(Mmin, sdphi2, po, k).cpu().numpy()
    ref = pass2_min(Mmin, sdphi2, po, k).cpu().numpy()
    if not np.array_equal(got > BIG / 2, ref > BIG / 2):
        raise AssertionError(f"B2 {name}: BIG structure differs")
    sel = ref < BIG / 2
    err = float(np.abs(got[sel] - ref[sel]).max()) if sel.any() else 0.0
    if not np.array_equal(got[sel], ref[sel]):
        raise AssertionError(f"B2 {name}: not bit-equal, max |diff| {err}")
    nwin = 2 * k + 1
    t = timing(lambda: pass2_min_cuda(Mmin, sdphi2, po, k),
               lambda: pass2_min(Mmin, sdphi2, po, k),
               4 * (Mmin.numel() + nlat * nlon + 2 * nlat * nwin),
               3 * nwin * nlat * nlon,
               library_note="none: no single PyTorch call takes a min over "
                            "a weighted lat window")
    log(f"# B2 pass2_min {name} k={k}: bit-equal to plain "
        f"({int(sel.sum())} finite cells); {fmt_timing(t)}")
    out[name] = dict(max_abs_err=err, k=k, **t)


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
    # the bound: 28 bytes in and 20 out per cell of the coastal tiles (the
    # bound's unit), and the ring additions of the radii each tile runs
    unit = tile_mask(cd, params.maxdist)
    tiles, cells, adds = ring_work(cd_pad, cd, nn, params.maxdist, unit)
    t = timing(kernel, plain, 48 * cells + unit.numel(), adds,
               library_note="none: no PyTorch call runs an expanding-ring "
                            "search")
    share = {f"{th}x{tw}": int(tile_mask(cd, params.maxdist, (th, tw)).sum())
             / tile_mask(cd, params.maxdist, (th, tw)).numel()
             for th, tw in ((16, 32), (32, 32), (32, 64), (64, 64))}
    radii = latch_radius(cd_pad, cd, nn, params.maxdist)
    band = radii[radii > 0].double()
    log(f"# B1 ring_trigger {name} NN={nn}: 3-step scan from tt=14 matches "
        f"plain (final ws/wd bit-equal); step max |diff| {err:.3g}; "
        f"{fmt_timing(t)}; {int(ever.sum())}/{ever.numel()} kernel tiles "
        f"coastal; f (coastal tile share) by tile {share}; {tiles} "
        f"{BOUND_TILE[0]}x{BOUND_TILE[1]} tiles, {cells} cells, {adds} ring "
        f"additions; latch radius over {band.numel()} coastal cells mean "
        f"{float(band.mean()):.2f}, max {int(band.max())}; scan ms/step "
        f"kernel path {runs['kernel'][2]:.2f}, plain path "
        f"{runs['plain'][2]:.2f}")
    out[name] = dict(max_abs_err=err, nn=nn, f=share[f"{BOUND_TILE[0]}x"
                                                     f"{BOUND_TILE[1]}"],
                     f_by_tile=share, **t)


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
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"ring_trigger_stacked": T, dist_kernel(): T + 1}  # + the probe
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
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


def regional_world(spacing, lat0, steps):
    """A kilometre-scale regional world: ``(grid, (lsm, z, std, pres,
    theta, u, v, ci))``, FINE_N x FINE_N cells ``spacing`` degrees apart
    from ``lat0`` southward, 4 levels, ``steps`` steps of
    ``bench.make_world`` fields."""
    from bench import make_world
    from seabreeze_param_tpu_torch.core.grid import Grid
    n = FINE_N
    grid = Grid.regular(n, n, lat0=lat0, lat1=lat0 - (n - 1) * spacing,
                        lon0=0.0, lon1=n * spacing)
    return grid, make_world(n, n, 4, steps, seed=3)


@functools.cache
def fine_world():
    """1024 x 1024 cells 0.015 deg apart (about 1.5 km, the spacing of
    convection-permitting regional models), 55 to 39.655 N, 8 steps.  k =
    93, NN ~97 (the probe: 208): the ring kernels' large build."""
    return regional_world(FINE_SPACING, 55.0, FINE_STEPS)


@functools.cache
def km_world():
    """1024 x 1024 cells 0.009 deg apart (1 km), 54 to 44.793 N, 4 steps.
    k = 155; the probe takes NN to 243."""
    return regional_world(KM_SPACING, 54.0, KM_STEPS)


def diag_nn(grid):
    """The ring radius NN that ``diag`` ran at on ``grid`` (its sticky
    per-grid bound)."""
    from seabreeze_param_tpu_torch import api
    key = (grid.lon.tobytes(), grid.lat.tobytes())
    return max(v for k, v in api._CACHE.items()
               if k[:2] == key and k[-1] == "ring_nn")


def regional_diag(world, what, least_nn):
    """``diag`` over a regional world (:func:`regional_world`), kernel path
    against plain (final ws/wd bit-equal), B1 launched once a step and the
    distance kernel (:func:`dist_kernel`) once more for the probe, at an NN
    of at least ``least_nn``."""
    import torch
    from seabreeze_param_tpu_torch.api import diag
    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    T, nlat, nlon = theta.shape
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = diag(*args, device="cuda", full_output=True, **kw)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / T * 1e3

    run()                                       # warm-up
    zero_launches()
    kern, kms = run()
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"ring_trigger_stacked": T, dist_kernel(): T + 1}  # + the probe
    if launches != want:
        raise AssertionError(f"{what} diag launches {launches}, want {want}")
    nn = diag_nn(grid)
    if nn < least_nn:
        raise AssertionError(f"{what} diag ran at NN = {nn} < {least_nn}")
    plain, pms = run(use_kernels=False)
    if kern[0] != plain[0] or kern[0] != 1 + T:
        raise AssertionError(f"{what} diag: tt differs")
    worst = check_fields(kern[5], plain[5], f"{what} diag per-step outputs")
    check_fields(dict(thc=kern[2], windspeed=kern[3], winddir=kern[4]),
                 dict(thc=plain[2], windspeed=plain[3], winddir=plain[4]),
                 f"{what} diag final state",
                 bit_state=("windspeed", "winddir"))
    sb = kern[1]
    if sb.shape != (T, nlat, nlon) or not np.isfinite(sb).all():
        raise AssertionError(f"{what} diag: sb_con shape or finiteness")
    return dict(launches=launches, nn=nn, T=T, ms_per_step=kms,
                plain_ms_per_step=pms, max_abs_err=worst,
                missing=float((sb == MISSING).mean()),
                triggers=int(((sb != MISSING) & (sb != 0)).sum()))


def ring_alone(world, nn, what, *, time_b1=True, time_b4=False, step=2):
    """B1, B4 and B5 alone on ``step``'s inputs of a regional world padded at
    ``nn``, each bit-equal to its plain version; B1 (and, with ``time_b4``,
    B4) timed.  Returns {"b1": ..., "b4": ...} of the timed kernels and the
    coastal cells' latch radii."""
    import torch
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        StackedScan, ring_thc_cuda_padded, ring_trigger_cuda_padded,
        ring_trigger_cuda_stacked)
    from seabreeze_param_tpu_torch.ops.ring_search import (
        ring_quantities, ring_thc_from_padded)
    from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                       trigger_cells)
    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    nlat, nlon = grid.shape
    dev = torch.device("cuda")
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    params = Params()
    pipe = TriggerPipeline(grid, device=dev)
    cd = pipe.distance_field(D(lsm), D(ci[step]))
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[step]), D(u[step]), D(v[step]), cd, D(z), D(std), D(pres),
        params, nn)
    rng = np.random.default_rng(1)
    ws0 = D((5 + rng.random((nlat, nlon))).astype(np.float32))
    wd0 = D((360 * rng.random((nlat, nlon)) - 180).astype(np.float32))
    flags = cadence(15, params)
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad, *flags,
                        params, nn)
    scan = StackedScan(nlat, nlon, params, dev)
    bufs = scan.init_buffers(1, ws0, wd0)
    ever = scan.add_coastal(cd)
    ws_s, wd_s = ws0.clone(), wd0.clone()

    def b1():
        ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s,
                                  wd_s, *flags, params, nn, 0, *bufs, ever)

    def b4():
        return ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new, wd_new,
                                        ws0, wd0, *flags, params, nn)

    def plain():
        return trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                             *flags, params, nn)

    b1()
    err1 = max(bit_equal(b[0], r, f"{what} B1 {f}")
               for b, r, f in zip(bufs, ref, ("sb", "ws", "wd")))
    err4 = max(bit_equal(g, r, f"{what} B4 {f}") for g, r, f in zip(
        b4(), (ref[0], ref[3], ref[4]), ("sb", "ws", "wd")))
    bit_equal(ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn),
              ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                                   torch.where(cd >= 0, 1.0, -1.0), nn,
                                   coastal=cd.abs() <= float(np.float32(
                                       params.maxdist)))[0], f"{what} B5")
    none = "none: no PyTorch call runs an expanding-ring search"
    unit = tile_mask(cd, params.maxdist)
    f = int(unit.sum()) / unit.numel()
    res = {}
    # the plain version runs ~12 kernels a radius, ~1200-3000 here
    if time_b1:
        _, cells, adds = ring_work(cd_pad, cd, nn, params.maxdist, unit)
        res["b1"] = dict(max_abs_err=err1, nn=nn, f=f, **timing(
            b1, plain, 48 * cells + unit.numel(), adds, library_note=none,
            plain_queued=True))
    if time_b4:
        # as phase_padded: the padded pair and five fields of every cell
        # read, three written; the additions of the tiles holding a coastal
        # cell
        _, _, adds = ring_work(cd_pad, cd, nn, params.maxdist)
        res["b4"] = dict(max_abs_err=err4, nn=nn, f=f, **timing(
            b4, plain, 4 * (t0_pad.numel() + cd_pad.numel() + 8 * nlat * nlon),
            adds, library_note=none, plain_queued=True))
    radii = latch_radius(cd_pad, cd, nn, params.maxdist)
    res["radii"] = radii[radii > 0].double()
    res["k"] = pipe.k
    return res


def b3_bound(cpad, amin, k):
    """B3's least work on one call: its bytes (the padded coast field and
    the three tables read once, amin written once) and its operations: a
    comparison and a select per padded cell for pass 1, and for pass 2 a
    multiply, an add and a minimum on each of the 2k+1 taps of the outputs
    in reach (amin < BIG/2; the others need no tap: their windows hold no
    coast).  Returns (bytes, operations)."""
    h, w = amin.shape
    nwin = 2 * k + 1
    reach = int((amin < float(BIG) / 2).sum())
    return (4 * (cpad.numel() + h * w + (2 * h + w) * nwin),
            2 * (h + 2 * k) * w + 3 * nwin * reach)


def fused_regional(world, what):
    """B3 on a regional world's first step: ``TriggerPipeline(
    distance_impl='fused')``'s distance bit-equal to the hybrid's (the
    first design refused k >= 89), B3 alone bit-equal to plain and timed
    beside the hybrid (torch pass 1 + B2; both plain versions launch
    ~3(2k+1) kernels a call, more than the card queues, so they are timed
    by events around calls)."""
    import torch
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        min_haversine_param_cuda, pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.distance import (
        min_haversine_param_from_padded, pad_coast, pass1_extrema)
    grid, (lsm, *_, ci) = world
    dev = torch.device("cuda")
    L, C = (torch.as_tensor(a, device=dev) for a in (lsm, ci[0]))
    fused = TriggerPipeline(grid, device=dev, distance_impl="fused")
    hybrid = TriggerPipeline(grid, device=dev, distance_impl="hybrid")
    zero_launches()
    fd = fused.distance_field(L, C)
    launches = {n: c for n, c in read_launches().items() if c}
    if launches != {"min_haversine": 1}:
        raise AssertionError(f"{what} fused distance launches {launches}")
    bit_equal(fd, hybrid.distance_field(L, C),
              f"{what} fused distance vs hybrid")
    k, tabs = fused.k, fused._tables()
    cpad = pad_coast(get_edges(L, C), k)

    def b3():
        return min_haversine_param_cuda(cpad, *tabs, k,
                                        monotone=tabs.monotone)

    amin = b3()
    err = bit_equal(amin, min_haversine_param_from_padded(cpad, *tabs, k),
                    f"{what} B3")
    nbytes, ops = b3_bound(cpad, amin, k)
    none = "none: no PyTorch call runs a masked min over a separable window"
    return dict(max_abs_err=err, k=k, hybrid_ms=call_ms(
        lambda: pass2_min_cuda(pass1_extrema(cpad, tabs[2], k)[0], tabs[0],
                               tabs[1], k), reps=3),
        **timing(b3, lambda: min_haversine_param_from_padded(
            cpad, *tabs, k), nbytes, ops, library_note=none,
            plain_queued=True))


def fmt_b3(r):
    return (f"fused distance (TriggerPipeline(distance_impl='fused')) "
            f"bit-equal to the hybrid's on step 0; B3 at k={r['k']} "
            f"bit-equal to plain, {fmt_timing(r)} (plain: events around "
            f"calls); hybrid distance {r['hybrid_ms']:.4f} ms (events "
            f"around calls)")


def fmt_radii(r):
    return (f"latch radius over {r.numel()} coastal cells mean "
            f"{float(r.mean()):.2f}, max {int(r.max())}")


def phase_fine(out):
    """The fine regional world (:func:`fine_world`), whose ring radius takes
    the large build of B1, B4 and B5: ``diag`` for 8 steps, kernel path
    against plain (final ws/wd bit-equal); the coupled step
    (``prepare_mask`` + ``physics``, B3 + B4) over the same steps against
    plain; B1, B4 and B5 alone on one step, bit for bit, at ``diag``'s NN
    (B1 timed) and at the coupled step's (B4 timed); the fused distance
    and B3 at k = 93 (:func:`fused_regional`)."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.coupling import CoupledTrigger
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import ring_limits

    world = fine_world()
    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    T, nlat, nlon = theta.shape
    dev = torch.device("cuda")
    large_from = ring_limits()[0]
    dg = regional_diag(world, "fine", large_from)
    nn = dg["nn"]

    # the coupled step on every step of the world
    d = {k: torch.as_tensor(a, device=dev) for k, a in dict(
        lsm=lsm, z=z, std=std, pres=pres, theta=theta, u=u, v=v,
        ci=ci).items()}

    def drive(uk):
        ct = CoupledTrigger(grid, use_kernels=uk, device=dev)
        state = TriggerState.zeros((nlat, nlon), dev)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            cd = ct.prepare_mask(d["lsm"], d["ci"][t])
            state, o = ct.physics(state, d["pres"], d["u"][t], d["v"][t],
                                  d["theta"][t], d["z"], d["std"], cd)
            outs.append(o)
        torch.cuda.synchronize()
        return state, outs, (time.perf_counter() - t0) / T * 1e3

    drive(None)                                 # warm-up
    zero_launches()
    cstate, couts, cms = drive(None)
    claunches = {n: c for n, c in read_launches().items() if c}
    if claunches != {"ring_trigger_padded": T, dist_kernel(): T}:
        raise AssertionError(f"fine coupled launches {claunches}")
    pstate, pouts, cpms = drive(False)
    cworst = 0.0
    for t, (ko, po) in enumerate(zip(couts, pouts)):
        cworst = max(cworst, check_fields(
            {k: o.cpu() for k, o in ko.items()},
            {k: o.cpu() for k, o in po.items()}, f"fine coupled step {t}"))
    check_fields(final_fields(cstate), final_fields(pstate),
                 "fine coupled final state",
                 bit_state=("windspeed", "winddir"))
    cnn = CoupledTrigger(grid, device=dev).pipeline().nn_max
    if cnn < large_from:
        raise AssertionError(f"fine coupled step at NN = {cnn}: not the "
                             f"large build")

    alone = ring_alone(world, nn, "fine")
    coupled = ring_alone(world, cnn, f"fine NN={cnn}", time_b1=False,
                         time_b4=True)
    b3 = fused_regional(world, "fine")
    smi = nvidia_smi()
    log(f"# fine regional {nlat}x{nlon} at {FINE_SPACING} deg (k="
        f"{alone['k']}, NN={nn}: the ring kernels' large build), {smi}: "
        f"diag T={T} kernel path {dg['ms_per_step']:.3f} ms/step, plain "
        f"path {dg['plain_ms_per_step']:.3f} ms/step; launches "
        f"{dg['launches']}; matches plain (max |diff| "
        f"{dg['max_abs_err']:.3g}, final ws/wd bit-equal); sb missing "
        f"fraction {dg['missing']:.4f}, nonzero triggers {dg['triggers']}; "
        f"coupled step (NN={cnn}) kernel path {cms:.3f} ms/step, plain "
        f"{cpms:.3f}; launches {claunches}; matches plain (max |diff| "
        f"{cworst:.3g}, final ws/wd bit-equal); B1, B4, B5 bit-equal to "
        f"plain on one step at NN={nn} and NN={cnn}; B1 at NN={nn} "
        f"{fmt_timing(alone['b1'])} (plain: events around calls); f "
        f"{alone['b1']['f']:.4f}; {fmt_radii(alone['radii'])}; B4 at "
        f"NN={cnn} {fmt_timing(coupled['b4'])}; {fmt_b3(b3)}")
    out.update(launches=dg["launches"], coupled_launches=claunches, nn=nn,
               coupled_nn=cnn, large_from=large_from,
               ms_per_step=dg["ms_per_step"],
               plain_ms_per_step=dg["plain_ms_per_step"],
               coupled_ms_per_step=cms, coupled_plain_ms_per_step=cpms,
               b1=alone["b1"], b4=coupled["b4"], b3=b3)


def phase_km(out):
    """The 1 km world (:func:`km_world`), whose probe takes the ring radius
    to 243: ``diag`` for 4 steps, kernel path against plain (final ws/wd
    bit-equal; B1 launched 4 times, the distance kernel 5); B1, B4 and B5
    alone on one step at ``diag``'s NN, bit for bit, B1 timed; the fused
    distance and B3 at k = 155 (:func:`fused_regional`)."""
    world = km_world()
    grid = world[0]
    dg = regional_diag(world, "1 km", 243)
    alone = ring_alone(world, dg["nn"], "1 km")
    b3 = fused_regional(world, "1 km")
    nlat, nlon = grid.shape
    log(f"# 1 km regional {nlat}x{nlon} at {KM_SPACING} deg (k="
        f"{alone['k']}, NN={dg['nn']}), {nvidia_smi()}: diag T={dg['T']} "
        f"kernel path {dg['ms_per_step']:.3f} ms/step, plain path "
        f"{dg['plain_ms_per_step']:.3f} ms/step; launches {dg['launches']}; "
        f"matches plain (max |diff| {dg['max_abs_err']:.3g}, final ws/wd "
        f"bit-equal); sb missing fraction {dg['missing']:.4f}, nonzero "
        f"triggers {dg['triggers']}; B1, B4, B5 bit-equal to plain on one "
        f"step; B1 {fmt_timing(alone['b1'])} (plain: events around calls); "
        f"f {alone['b1']['f']:.4f}; {fmt_radii(alone['radii'])}; "
        f"{fmt_b3(b3)}")
    out.update(launches=dg["launches"], nn=dg["nn"],
               ms_per_step=dg["ms_per_step"],
               plain_ms_per_step=dg["plain_ms_per_step"], b1=alone["b1"],
               b3=b3)


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def kernel_wrappers():
    """Name -> wrapper (whose ``launches`` counts its kernel) of every
    kernel of the port."""
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        min_haversine_param_cuda, pass2_min_cuda, pass2_min_two_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import (
        halo_exchange_cuda)
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        ring_thc_cuda_padded, ring_trigger_cuda_padded,
        ring_trigger_cuda_stacked)
    return {"pass2_min": pass2_min_cuda,
            "pass2_min_two": pass2_min_two_cuda,
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


def dist_kernel():
    """The wrapper (a name of :func:`kernel_wrappers`) that the card's
    default distance, ``impl='auto'``, launches: B3 for ``'fused'``, B2 for
    ``'hybrid'``.  Read from the package that runs, so the path phases hold
    either package to its own choice."""
    from seabreeze_param_tpu_torch.ops.distance import resolve_impl
    return {"fused": "min_haversine",
            "hybrid": "pass2_min"}[resolve_impl("auto", "cuda")]


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

    def b3():
        return min_haversine_param_cuda(cpad, *tabs, k,
                                        monotone=tabs.monotone)

    amin = b3()
    err = bit_equal(amin, min_haversine_param_from_padded(cpad, *tabs, k),
                    f"B3 {name}")
    n = nlat * nlon
    none = "none: no PyTorch call runs a masked min over a separable window"
    res["min_haversine"] = dict(
        max_abs_err=err,
        hybrid_ms=device_ms(lambda: pass2_min_cuda(
            pass1_extrema(cpad, tabs[2], k)[0], tabs[0], tabs[1], k)),
        **timing(b3, lambda: min_haversine_param_from_padded(cpad, *tabs, k),
                 *b3_bound(cpad, amin, k), library_note=none))

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
    # B4 and B5 read the padded pair and (B4) five fields of every cell and
    # write three (B5: one); their ring additions are those of the tiles
    # holding a coastal cell
    _, _, adds = ring_work(cd_pad, cd, nn, params.maxdist)
    pads = 4 * (t0_pad.numel() + cd_pad.numel())
    none = "none: no PyTorch call runs an expanding-ring search"
    res["ring_trigger_padded"] = dict(max_abs_err=err, **timing(
        lambda: ring_trigger_cuda_padded(*b4_args),
        lambda: trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                              *flags, params, nn),
        pads + 4 * 8 * n, adds, library_note=none))

    coastal = cd.abs() <= float(np.float32(params.maxdist))
    mul = torch.where(cd >= 0, 1.0, -1.0)

    def b5_plain():
        return ring_thc_from_padded(ring_quantities(t0_pad, cd_pad), mul, nn,
                                    coastal=coastal)[0]

    err = bit_equal(ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn), b5_plain(),
                    f"B5 {name}")
    res["ring_thc"] = dict(max_abs_err=err, **timing(
        lambda: ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn), b5_plain,
        pads + 4 * 2 * n, adds, library_note=none))
    log(f"# B3/B4/B5 {name} k={k} NN={nn}: bit-equal to plain (B4 at "
        f"tt=1/5/15); " + "; ".join(f"{kn}: {fmt_timing(m)}"
                                    for kn, m in res.items())
        + f"; hybrid distance device "
          f"{res['min_haversine']['hybrid_ms']:.4f} ms")
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
    if (launches["ring_trigger_padded"] != S
            or launches[dist_kernel()] != S):
        raise AssertionError(f"coupling launches {launches}, want B4 and "
                             f"{dist_kernel()} {S} times each")
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
    """The two distances of ``TriggerPipeline.run`` (B1 for the ring) for
    the 8 coupled steps, each launching its own kernel: ``'fused'`` (B3)
    against ``'hybrid'`` (torch pass 1 + B2), the first step's distance and
    the outputs bit-equal."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline

    dev = torch.device("cuda")
    grid, d = coupled_inputs(dev)
    nlat, nlon = grid.shape
    S = len(COUPLED_STEPS)
    pipes = {impl: TriggerPipeline(grid, device=dev, distance_impl=impl)
             for impl in ("fused", "hybrid")}
    bit_equal(pipes["fused"].distance_field(d["lsm"], d["ci"][0]),
              pipes["hybrid"].distance_field(d["lsm"], d["ci"][0]),
              "fused distance, first step")

    def run(pipe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pipe.run(TriggerState.zeros((nlat, nlon), dev), d["theta"],
                     d["u"], d["v"], d["lsm"], d["z"], d["std"], d["pres"],
                     ci_t=d["ci"])
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / S * 1e3

    res, launches, ms = {}, {}, {}
    for impl, kern in (("fused", "min_haversine"), ("hybrid", "pass2_min")):
        run(pipes[impl])                        # warm-up
        zero_launches()
        res[impl], ms[impl] = run(pipes[impl])
        launches[impl] = {n: c for n, c in read_launches().items() if c}
        want = {kern: S, "ring_trigger_stacked": S}
        if launches[impl] != want:
            raise AssertionError(f"{impl} run launches {launches[impl]}, "
                                 f"want {want}")
    (fstate, fouts), (hstate, houts) = res["fused"], res["hybrid"]
    worst = check_fields({k: o.cpu() for k, o in fouts.items()},
                         {k: o.cpu() for k, o in houts.items()},
                         "fused run per-step outputs")
    check_fields(final_fields(fstate), final_fields(hstate),
                 "fused run final state", bit_state=("windspeed", "winddir"))
    log(f"# fused and hybrid distance, global025 ({S} steps, moving ice): "
        f"first cdist bit-equal; run ms/step fused (B3+B1) "
        f"{ms['fused']:.3f}, hybrid (B2+B1) {ms['hybrid']:.3f}; launches "
        f"{launches}; outputs match (max |diff| {worst:.3g}, final ws/wd "
        f"bit-equal)")
    out.update(launches=launches, ms_per_step=ms["fused"],
               hybrid_ms_per_step=ms["hybrid"])


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
            or launches[dist_kernel()] != steps):
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
                want = plain()
                for s, (g, r) in enumerate(zip(kernel(), want)):
                    bit_equal(g, r, f"B6 {name} {tag} shard {s}")
                library = halo_take(local, mesh, width, kw)
                bit_equal(library(), torch.stack(want), f"B6 {name} {tag} "
                                                        f"library take")
                nbytes = 4 * sum(x.numel() + o.numel()
                                 for x, o in zip(local, want))
                rows[tag] = timing(
                    kernel, plain, nbytes, 0, library=library,
                    library_note="torch.take of the stacked shards through "
                                 "a precomputed index map")
    ref = rows[f"C=1 w={nn} clamp"]          # theta's exchange, every step
    log(f"# B6 halo_exchange {name} on {SHARD_MESH} ({h}x{w} shards, k={k} "
        f"NN={nn}): bit-equal to plain and to the library take at every "
        f"width and fill; " + "; ".join(f"{t}: {fmt_timing(m)}"
                                        for t, m in rows.items()))
    out[name] = dict(max_abs_err=0.0, shard=[h, w],
                     widths={t: {key: m[key] for key in (
                         "device_ms", "call_ms", "plain_ms", "bound_ms",
                         "library_ms")} for t, m in rows.items()}, **ref)


def halo_take(local, mesh, width, kw, edges=None):
    """One PyTorch call computing B6's padded shards, as its yardstick: an
    exchange of index fields (1-based; 0 where a fill puts a zero) gives the
    map, and ``torch.take`` of the stacked shards, a zero in front, reads
    every padded shard at once; ``edges`` (process edges on one card, as
    ``halo_exchange_cuda`` takes them) are indexed after the shards.
    Returns the call; stacking the inputs is not part of it."""
    import torch
    from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain
    dev = local[0].device
    n = local[0].numel()
    ids = [torch.arange(1 + s * n, 1 + (s + 1) * n, dtype=torch.float64,
                        device=dev).reshape(local[0].shape)
           for s in range(len(local))]
    parts, id_edges, top = [torch.stack(local).reshape(-1)], None, 1 + len(
        local) * n
    if edges:
        (pair,) = edges.values()
        id_pair = []
        for e in pair:
            id_pair.append(None if e is None else torch.arange(
                top, top + e.numel(), dtype=torch.float64,
                device=dev).reshape(e.shape))
            if e is not None:
                parts.append(e.reshape(-1))
                top += e.numel()
        id_edges = {dev: tuple(id_pair)}
    idx = torch.stack(halo_exchange_plain(ids, mesh, width, width,
                                          edges=id_edges, **kw)).long()
    src = torch.cat([torch.zeros(1, device=dev)] + parts)
    return lambda: torch.take(src, idx)


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
    16 steps of the main world: overlapped on the kernel path (B6 + B3 +
    B1) against the single-device kernel run (sharded tolerance) and its
    own plain path (final wind bit-equal), then basic (B6 + B3 + B4)
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
                        dist_kernel(): mesh.size * T},
            "basic": {"halo_exchange": 3 * T,
                      "ring_trigger_padded": mesh.size * T,
                      dist_kernel(): mesh.size * T}}
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
            dist_kernel(): 8 * T + 1}               # + the ring probe
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
            dist_kernel(): 8}
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


#: The multi-card phase: global 0.1 deg, MC_STEPS steps of a world whose
#: ice edge moves at step 4, on a MC_MESH mesh over min(count, 4) cards,
#: or, on one card, over MC_GROUPS groups of it.
MC_MESH, MC_STEPS, MC_GROUPS = (2, 2), 8, 4


@functools.cache
def multicard_world():
    """The multi-card phase's world at global 0.1 deg: ``(grid, (lsm, z,
    std, pres, theta, u, v, ci))``, MC_STEPS steps on 4 levels."""
    from bench import make_world
    grid, _, _ = world_grid("global010")
    lsm, z, std, pres, theta, u, v, ci = make_world(grid.nlat, grid.nlon, 4,
                                                    MC_STEPS)
    for t in range(MC_STEPS):
        ci[t] = 0.0
        ci[t, : grid.nlat // 12 + t // 4, :] = 0.8
    return grid, (lsm, z, std, pres, theta, u, v, ci)


def card_topology():
    """``nvidia-smi -L`` and ``nvidia-smi topo -m`` (one line each), or what
    they said instead."""
    lines = []
    for args in (["-L"], ["topo", "-m"]):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True)
        text = (r.stdout or r.stderr).strip().replace("\n", " | ")
        lines.append(f"nvidia-smi {' '.join(args)}: {text or 'no output'}")
    return lines


def b6_peer_bytes(mesh, h, w, hy, hx, c):
    """Per card, the bytes an exchange of (c, h, w) shards reads from shards
    on other cards (the halo strips and corners it takes from them) and
    the bytes it moves on the card (every source read once, every padded
    block written once)."""
    peer, local = {}, {}
    for s in range(mesh.size):
        iy, ix = mesh.coords(s)
        dev = mesh.device_of(s)
        remote = 0
        for dy, rows in ((-1, hy), (0, h), (1, hy)):
            if not 0 <= iy + dy < mesh.py:
                continue
            for dx, cols in ((-1, hx), (0, w), (1, hx)):
                if (dy, dx) == (0, 0):
                    continue
                n = (iy + dy) * mesh.px + (ix + dx) % mesh.px
                if mesh.device_of(n) != dev:
                    remote += rows * cols
        out = (h + 2 * hy) * (w + 2 * hx)
        peer[dev] = peer.get(dev, 0) + 4 * c * remote
        local[dev] = local.get(dev, 0) + 4 * c * (h * w + out)
    return peer, local


#: NVLink 4 between two H100s, each way (NVIDIA's data sheet).
PEAK_NVLINK = 450e9


def phase_multicard(out):
    """One decomposed-run mesh spread over several cards: global 0.1 deg,
    2 x 2 shards, MC_STEPS steps with moving ice, ``ShardedPipeline.run``
    over min(count, 4) cards, one shard group each, or on one card over
    MC_GROUPS groups of it (each group on its own stream, B6 launched once
    per group, events between the groups); overlapped (B6 + B3 + B1) and
    basic (B6 + B3 + B4) bit-equal to the one-group 2 x 2 mesh on the first
    card and the overlapped run within the sharded tolerance of the single
    device; ``diag(mesh='2x2')`` over the default devices and over the
    phase's against ``diag()``; B6 over the groups timed at theta's
    exchange (NN wide) beside one group's launch alone and its bound."""
    import torch
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.cuda import halo_kernel
    from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh, split
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    count = torch.cuda.device_count()
    cards = min(count, 4)
    devs = ([torch.device("cuda", i) for i in range(cards)] if cards > 1
            else [torch.device("cuda", 0)] * MC_GROUPS)
    dev0 = devs[0]
    mesh = make_mesh(MC_MESH, devs)
    one = make_mesh(MC_MESH, dev0)
    peer_shown = len(set(mesh.devices)) > 1
    grid, world = multicard_world()
    lsm, z, std, pres, theta, u, v, ci = world
    T, (nlat, nlon) = MC_STEPS, grid.shape
    d = [torch.as_tensor(a, device=dev0) for a in
         (theta, u, v, lsm, z, std, pres, ci)]
    single = TriggerPipeline(grid, device=dev0)
    nn, k = single.nn_max, single.k
    runners = {"groups": ShardedPipeline(single, mesh),
               "one": ShardedPipeline(single, one),
               "groups_basic": ShardedPipeline(single, mesh, overlap=False),
               "one_basic": ShardedPipeline(single, one, overlap=False),
               "single": single}
    if not (runners["groups"].overlap and runners["one"].overlap):
        raise AssertionError("multicard: the overlapped structure was not "
                             "chosen at global010 on 2x2")

    def run(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, o = runners[label].run(TriggerState.zeros((nlat, nlon), dev0),
                                   *d[:7], ci_t=d[7])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / T * 1e3
        return ({key: x.cpu() for key, x in o.items()}, final_fields(st), ms)

    exchanges = {"groups": 3 + 2 * T, "groups_basic": 3 * T}
    want = {"groups": {"halo_exchange": mesh.groups * exchanges["groups"],
                       "ring_trigger_stacked": mesh.size * T,
                       dist_kernel(): mesh.size * T},
            "groups_basic": {
                "halo_exchange": mesh.groups * exchanges["groups_basic"],
                "ring_trigger_padded": mesh.size * T,
                dist_kernel(): mesh.size * T}}
    res, launches = {}, {}
    for label in ("groups", "one", "single", "groups_basic", "one_basic"):
        first = run(label) if label in ("groups", "one", "single") else None
        zero_launches()
        res[label] = run(label)
        launches[label] = {n: c for n, c in read_launches().items() if c}
        if label in want and launches[label] != want[label]:
            raise AssertionError(f"multicard {label}: launches "
                                 f"{launches[label]}, want {want[label]}")
        if first is not None:
            for a, b in zip(first[:2], res[label][:2]):
                for key in a:
                    if not torch.equal(a[key], b[key]):
                        raise AssertionError(f"multicard {label}: two runs "
                                             f"differ in {key}")
    for grouped, ref in (("groups", "one"), ("groups_basic", "one_basic"),
                         ("groups_basic", "groups")):
        for a, b in zip(res[grouped][:2], res[ref][:2]):
            for key in a:
                bit_equal(a[key], b[key], f"multicard {grouped} vs {ref} "
                                          f"{key}")
    gr, sg = res["groups"], res["single"]
    off = outputs_sharded_close({key: x.numpy() for key, x in gr[0].items()},
                                {key: x.numpy() for key, x in sg[0].items()},
                                "multicard groups vs single device")
    np.testing.assert_allclose(gr[1]["thc"], sg[1]["thc"], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(gr[1]["windspeed"], sg[1]["windspeed"],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gr[1]["winddir"], sg[1]["winddir"], rtol=1e-5,
                               atol=1e-3)
    sb = gr[0]["sb_con"]
    if sb.shape != (T, nlat, nlon) or not torch.isfinite(sb).all():
        raise AssertionError("multicard: sb_con shape or finiteness")

    # diag over the default devices and over the phase's, against diag()
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    diags = {}
    for label, kw in (("default", dict(mesh="2x2")),
                      ("devices", dict(mesh="2x2", device=devs)),
                      ("single", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diags[label] = (diag(*args, full_output=True, **kw),
                        (time.perf_counter() - t0) / T * 1e3)
    for label in ("default", "devices"):
        r = diags[label][0]
        if r[0] != diags["single"][0][0] or r[0] != 1 + T:
            raise AssertionError(f"multicard diag {label}: tt differs")
        outputs_sharded_close(r[5], diags["single"][0][5],
                              f"multicard diag(mesh='2x2') {label} vs diag()")
    if count == 1:    # the default devices: the one card, one group
        for a, b in zip(diags["default"][0][1:5], diags["devices"][0][1:5]):
            if not np.array_equal(a, b):
                raise AssertionError("multicard diag: groups vs one group")

    # B6 over the groups at theta's exchange, NN wide, one channel
    h, w = -(-nlat // mesh.py), nlon // mesh.px
    gen = torch.Generator(device=dev0).manual_seed(6)
    field = torch.randn((MC_MESH[0] * h, MC_MESH[1] * w), generator=gen,
                        device=dev0)
    local = split(field, mesh)
    kw = dict(lat_fill="clamp", exact_lon=False)

    def kernel():
        return halo_kernel.halo_exchange_cuda(local, mesh, nn, nn, **kw)

    def plain():
        return halo_exchange_plain(local, mesh, nn, nn, **kw)

    got, want_b6 = kernel(), plain()
    for s, (g, r) in enumerate(zip(got, want_b6)):
        bit_equal(g, r, f"multicard B6 shard {s}")
    src = (halo_kernel.ctypes.c_void_p * mesh.size)(
        *(x.data_ptr() for x in local))

    def group0():
        with torch.cuda.device(mesh.devices[0]):
            return halo_kernel._launch(src, mesh, (h, w), (nn, nn, 0, 0),
                                       (None, None), mesh.group_shards(0))

    peer, loc = b6_peer_bytes(mesh, h, w, nn, nn, 1)
    if peer_shown:
        bound_ms = max(peer[c] / PEAK_NVLINK + loc[c] / PEAK_BYTES
                       for c in peer) * 1e3
    else:
        bound_ms = sum(loc.values()) / PEAK_BYTES * 1e3
    library = (None if peer_shown else halo_take(local, mesh, nn, kw))
    t = timing(kernel, plain, sum(loc.values()), 0, library=library,
               library_note="torch.take of the stacked shards (one card "
                            "only)")
    t.update(bound_ms=bound_ms, share_of_bound=bound_ms / t["device_ms"],
             bound_by="bytes", group_device_ms=device_ms(group0),
             groups=mesh.groups, cards=len(set(mesh.devices)),
             peer_path=peer_shown, max_abs_err=0.0,
             peer_bytes=sum(peer.values()))
    smi = nvidia_smi()
    per_step = want["groups"]["halo_exchange"] / T
    for line in card_topology():
        log(f"# multicard {line}")
    log(f"# multicard global010 on {MC_MESH[0]}x{MC_MESH[1]} (T={T}, k={k}, "
        f"NN={nn}, moving ice) [{smi}]: {count} card(s) visible, "
        f"{t['cards']} card(s) in the mesh, {mesh.groups} groups; peer path "
        f"across cards {'shown' if peer_shown else 'NOT shown (one card)'}; "
        f"ShardedPipeline.run with inputs resident, ms/step: groups "
        f"{gr[2]:.3f} (basic {res['groups_basic'][2]:.3f}), one group "
        f"{res['one'][2]:.3f} (basic {res['one_basic'][2]:.3f}), single "
        f"device {sg[2]:.3f}; launches {launches['groups']} (overlapped), "
        f"{launches['groups_basic']} (basic); B6 launches per step "
        f"{per_step:g} ({mesh.groups} groups x 2 exchanges, + "
        f"{3 * mesh.groups} a run); groups bit-equal to one group "
        f"(overlapped, basic, each run twice), basic bit-equal to "
        f"overlapped; matches the single device (largest fraction off "
        f"{off:.3g}); diag(mesh='2x2') default devices / the phase's / "
        f"diag() {diags['default'][1]:.3f} / {diags['devices'][1]:.3f} / "
        f"{diags['single'][1]:.3f} ms/step (first calls, host arrays), "
        f"matching diag()")
    log(f"# multicard B6 at global010 NN={nn} ({h}x{w} shards, "
        f"{mesh.groups} groups) [{smi}]: bit-equal to plain; whole exchange "
        f"{fmt_timing(t)}; one group's launch alone "
        f"{t['group_device_ms'] * 1e3:.1f} us; peer bytes "
        f"{t['peer_bytes']}")
    out.update(launches=launches, groups=mesh.groups, cards=t["cards"],
               count=count, peer_path=peer_shown,
               ms_per_step={x: res[x][2] for x in res}, b6=t,
               diag_ms_per_step={x: diags[x][1] for x in diags})


DRIVER_CONF = """datadir = {root}/data
landfracfile = {root}/data/static_slm.nc
topofile = {root}/data/static_topo.nc
orofile = {root}/data/static_topo.nc
prefix = Synth_
vtheta = t2m
vu = u
vv = v
vlon = longitude
vlat = latitude
vpres = level
vci = ci
vlandfrac = lsm
vz = z
vstd = sdfor
vtime = time
plev = 700
start = 1987-01-01_00:00
end = 1987-01-{end:02d}_00:00
"""


def write_series(root):
    """The main world's first ``DRIVER_DAYS * DRIVER_STEPS`` steps as a
    daily netCDF series under ``root``, in the layout of
    ``tests/test_io.py`` and with the port's writer: static files for lsm
    and for z and std, per day one file each of t2m, u, v and ci.  Returns
    the run.conf of the whole series and that of its first two days."""
    from datetime import datetime
    from seabreeze_param_tpu_torch.io import Dataset, date2num

    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "1987"))

    def coords(f):
        for name, vals in (("longitude", grid.lon), ("latitude", grid.lat)):
            f.createDimension(name, len(vals))
            f.createVariable(name, "f", (name,))[:] = vals

    for fname, fields in (("static_slm.nc", {"lsm": lsm}),
                          ("static_topo.nc", {"z": z, "sdfor": std})):
        with Dataset(os.path.join(data, fname), "w") as f:
            coords(f)
            for name, a in fields.items():
                f.createVariable(name, "f", ("latitude", "longitude"))[:] = a
    units = "hours since 1987-01-01 00:00:00"
    for d in range(DRIVER_DAYS):
        sel = slice(d * DRIVER_STEPS, (d + 1) * DRIVER_STEPS)
        times = [datetime(1987, 1, d + 1, 6 * i) for i in range(DRIVER_STEPS)]
        for name, a in (("t2m", theta), ("u", u), ("v", v), ("ci", ci)):
            path = os.path.join(data, "1987",
                                f"Synth_{name}_1987_01_{d + 1:02d}.nc")
            with Dataset(path, "w") as f:
                f.createDimension("time", None)
                f.createDimension("level", len(pres))
                coords(f)
                f.createVariable("time", "d", ("time",))[:] = date2num(
                    times, units)
                f.variables["time"].setncattr("units", units)
                f.createVariable("level", "f", ("level",))[:] = pres
                dims = ("time",) + (("level",) if a.ndim == 4 else ()) + (
                    "latitude", "longitude")
                f.createVariable(name, "f", dims)[:] = a[sel]
    confs = []
    for end in (DRIVER_DAYS + 1, 3):
        confs.append(os.path.join(root, f"run_{end}.conf"))
        with open(confs[-1], "w") as f:
            f.write(DRIVER_CONF.format(root=root, end=end))
    return confs


def driver_run(conf, spent=None, keep=False, **kw):
    """The port's batch driver on the card: ``(state, files)``, the final
    ``(tt, thc, ws, wd)`` and per written file its sb_con and thc, read
    back and the file removed unless ``keep``.  With ``spent`` (a dict),
    the wall seconds of the run and of its reading, its ``diag`` calls
    (reads inside them excluded) and its writing are added to it."""
    import torch
    from seabreeze_param_tpu_torch import api
    from seabreeze_param_tpu_torch.cli import run
    from seabreeze_param_tpu_torch.io import Dataset, meta, netcdf

    patches = []
    if spent is not None:
        inside = []

        def wrap(owner, name, key):
            fn = getattr(owner, name)

            def timed(*a, **k):
                inside.append(key)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    dt = time.perf_counter() - t0
                    inside.pop()
                    spent[key] = spent.get(key, 0.0) + dt
                    if key == "read" and "diag" in inside:
                        spent["read_in_diag"] = spent.get(
                            "read_in_diag", 0.0) + dt
            patches.append((owner, name, fn))
            setattr(owner, name, timed)

        wrap(run, "read_nc", "read")
        wrap(netcdf.Variable, "__getitem__", "read")
        wrap(api, "diag", "diag")
        wrap(meta.Meta, "create_nc", "write")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, written = run.main(conf, progress=None, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for owner, name, fn in patches:
            setattr(owner, name, fn)
    if spent is not None:
        spent["wall"] = spent.get("wall", 0.0) + wall
    files = []
    for path in written:
        with Dataset(path) as f:
            files.append({k: np.ma.getdata(f.variables[k][:])
                          for k in ("sb_con", "thc")})
        if not keep:
            os.remove(path)
    return tuple(state), files


def same_run(a, b, what):
    """Two driver runs bit-equal: final state and written files."""
    (sa, fa), (sb, fb) = a, b
    if sa[0] != sb[0] or len(fa) != len(fb):
        raise AssertionError(f"{what}: tt or file count differs")
    for x, y, name in zip(sa[1:], sb[1:], ("thc", "ws", "wd")):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: final {name} not bit-equal")
    for i, (ga, gb) in enumerate(zip(fa, fb)):
        for key in ga:
            if not np.array_equal(ga[key], gb[key]):
                raise AssertionError(f"{what}: file {i} {key} not bit-equal")


def phase_driver(out):
    """The batch driver (``cli/run.py``) at global 0.25 deg over a daily
    netCDF series of the main world (3 files of 4 steps, the ice edge
    moving at step 8), written with the port's writer into a temporary
    directory and read back through the native reader: kernel path against
    the plain path; bit-equal to the same three ``diag`` calls on the
    in-memory arrays; ``--mesh=2x4`` against the single device; a resume
    from a checkpoint bit-equal to the unbroken run; the composites."""
    import shutil
    import tempfile
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.cli import composites
    from seabreeze_param_tpu_torch.io import Dataset, native_nc

    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    nlat, nlon = grid.shape
    T = DRIVER_DAYS * DRIVER_STEPS
    root = tempfile.mkdtemp(prefix="sb_driver_")
    try:
        t0 = time.perf_counter()
        conf, conf2 = write_series(root)
        write_s = time.perf_counter() - t0
        with Dataset(os.path.join(root, "data", "1987",
                                  "Synth_u_1987_01_01.nc")) as f:
            if not native_nc.available() or f._native is None:
                raise AssertionError("driver: the native reader is not used")

        unbroken = driver_run(conf)                     # and warm-up
        zero_launches()
        spent, mfile = {}, os.path.join(root, "metrics.jsonl")
        kern = driver_run(conf, spent, metrics_file=mfile)
        launches = {n: c for n, c in read_launches().items() if c}
        want = {"ring_trigger_stacked": T,
                dist_kernel(): T + DRIVER_DAYS}         # + a probe per file
        if launches != want:
            raise AssertionError(f"driver launches {launches}, want {want}")
        same_run(kern, unbroken, "driver rerun")
        with open(mfile) as f:
            metrics = [json.loads(line) for line in f]
        if len(metrics) != DRIVER_DAYS:
            raise AssertionError("driver: one metrics line per file")

        plain_spent = {}
        plain = driver_run(conf, plain_spent, use_kernels=False)
        if {n: c for n, c in read_launches().items() if c} != launches:
            raise AssertionError("driver: the plain path launched a kernel")
        worst = 0.0
        for fk, fp in zip(kern[1], plain[1]):
            worst = max(worst, check_fields(fk, fp, "driver vs plain"))
        check_fields(dict(zip(("thc", "windspeed", "winddir"), kern[0][1:])),
                     dict(zip(("thc", "windspeed", "winddir"), plain[0][1:])),
                     "driver final state", bit_state=("windspeed", "winddir"))
        sb = np.concatenate([f["sb_con"] for f in kern[1]])
        if sb.shape != (T, nlat, nlon) or not np.isfinite(sb).all():
            raise AssertionError("driver: sb_con shape or finiteness")

        # the same three diag calls on the in-memory arrays, state threaded
        state = (1,) + tuple(np.zeros((nlat, nlon), np.float32)
                             for _ in range(3))
        direct = []
        for d in range(DRIVER_DAYS):
            sel = slice(d * DRIVER_STEPS, (d + 1) * DRIVER_STEPS)
            r = diag(state[0], lsm, z, std, grid.lon, grid.lat, pres, u[sel],
                     v[sel], theta[sel], ci[sel], thc=state[1], ws=state[2],
                     wd=state[3], device="cuda", full_output=True)
            state = (r[0],) + tuple(r[2:5])
            direct.append({"sb_con": r[1], "thc": r[5]["t0"]})
        same_run(kern, (state, direct), "driver vs direct diag calls")

        zero_launches()
        mesh_spent = {}
        meshed = driver_run(conf, mesh_spent, mesh=SHARD_MESH)
        mesh_launches = {n: c for n, c in read_launches().items() if c}
        mesh_want = {"halo_exchange": DRIVER_DAYS * (3 + 2 * DRIVER_STEPS),
                     "ring_trigger_stacked": 8 * T,
                     dist_kernel(): 8 * T + DRIVER_DAYS}
        if mesh_launches != mesh_want:
            raise AssertionError(f"driver mesh launches {mesh_launches}, "
                                 f"want {mesh_want}")
        off = max(outputs_sharded_close(fm, fk, "driver mesh vs single")
                  for fm, fk in zip(meshed[1], kern[1]))
        for i, (name, rtol, atol) in enumerate((("thc", 1e-6, 1e-5),
                                                ("ws", 1e-6, 1e-5),
                                                ("wd", 1e-5, 1e-3)), 1):
            np.testing.assert_allclose(meshed[0][i], kern[0][i], rtol=rtol,
                                       atol=atol, err_msg=name)

        # resume: stop after day 2, rerun the whole series, rerun again;
        # the first two runs keep their files, which are the whole series
        ck = os.path.join(root, "ck")
        first = driver_run(conf2, keep=True, ckpt_dir=ck)
        if first[0][0] != 1 + 2 * DRIVER_STEPS:
            raise AssertionError(f"driver first two days: tt {first[0][0]}")
        same_run(first, (first[0], unbroken[1][:2]), "driver first two days")
        resumed = driver_run(conf, keep=True, ckpt_dir=ck)
        same_run(resumed, (unbroken[0], unbroken[1][2:]), "driver resume")
        zero_launches()
        again = driver_run(conf, ckpt_dir=ck)
        if again[1] or any(read_launches().values()):
            raise AssertionError("driver: a finished series recomputed")
        same_run(again, (unbroken[0], []), "driver resume, finished series")

        # the composites read the sb files the resumed runs left
        ncout, maps = composites.main(conf, plot=False, progress=None)
        with Dataset(ncout) as f:
            comp = f.variables["sb_con"].shape
        if comp != (4 * DRIVER_STEPS, nlat, nlon) or maps:
            raise AssertionError(f"composites: shape {comp}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ms = spent["wall"] / T * 1e3
    shares = {k: spent.get(k, 0.0) / spent["wall"] for k in ("read", "write")}
    shares["diag"] = (spent["diag"] - spent.get("read_in_diag", 0.0)) \
        / spent["wall"]
    plain_ms = plain_spent["wall"] / T * 1e3
    mesh_ms = mesh_spent["wall"] / T * 1e3
    log(f"# driver global025 ({nlat}x{nlon}, {DRIVER_DAYS} daily files x "
        f"{DRIVER_STEPS} steps, series written in {write_s:.1f} s): kernel "
        f"path {ms:.3f} ms/step, plain path {plain_ms:.3f} ms/step; wall "
        f"shares read {shares['read']:.3f}, diag {shares['diag']:.3f}, "
        f"write {shares['write']:.3f}; launches {launches}; matches plain "
        f"(max |diff| {worst:.3g}, final ws/wd bit-equal); bit-equal to the "
        f"direct diag calls; --mesh={SHARD_MESH} {mesh_ms:.3f} ms/step, "
        f"launches {mesh_launches}, matches single (largest fraction off {off:.3g}); resume bit-equal; "
        f"native reader; composites {comp}")
    log(f"# driver metrics line keys: {sorted(metrics[-1])}")
    out.update(launches=launches, mesh_launches=mesh_launches,
               ms_per_step=ms, plain_ms_per_step=plain_ms,
               mesh_ms_per_step=mesh_ms, shares=shares)


@functools.cache
def wide_world(spacing):
    """A FINE_N x FINE_N world ``spacing`` degrees apart from 54 N
    southward, WIDE_STEPS steps (:func:`regional_world`)."""
    return regional_world(spacing, 54.0, WIDE_STEPS)


def wide_kernels(world, what):
    """B3 and B2 alone on step 0 of a wide-radius world, each bit-equal to
    its plain version with the rows' flags of the tables and without, and
    timed with them.  Beside each: the taps a warp takes in the host model
    of their schedule (``tools/pruned_model.py::pass2_centre_out``, which
    must give the same output).  The bounds count bytes (inputs read once,
    the tables and flags included, the output written once) against
    operations: 3 a tap of the least taps an exact exit needs, each column
    on its own (``pass2_least_taps``: no warp, group or repeat; B3's rows
    whose window holds no coast take none), and 2 a padded cell for B3's
    pass 1.  ``all_taps_*`` is the operations' figure where every output
    in reach takes all 2k+1 taps (the bound before the early exit).  Each
    entry keeps its kernel's call under ``call``."""
    import torch
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        min_haversine_limits, min_haversine_param_cuda, pass2_min_cuda,
        pass2_min_limits, pruned_layout)
    from seabreeze_param_tpu_torch.ops.distance import (
        min_haversine_param_from_padded, pad_coast, pass1_extrema, pass2_min)
    from tools.pruned_model import pass2_centre_out, pass2_least_taps
    grid, (lsm, *_, ci) = world
    dev = torch.device("cuda")
    pipe = TriggerPipeline(grid, device=dev)
    k, tabs = pipe.k, pipe._tables()
    if k <= min_haversine_limits() or k <= pass2_min_limits():
        raise AssertionError(f"{what}: k = {k} is not past both limits")
    L, C = (torch.as_tensor(a, device=dev) for a in (lsm, ci[0]))
    cpad = pad_coast(get_edges(L, C), k)
    sdphi2, po, sdlam2 = tabs
    rows = tabs.row_monotone
    if not bool(rows.all()):
        raise AssertionError(f"{what}: a row of sdphi2 lacks the flag")

    def b3(flags=rows):
        return min_haversine_param_cuda(cpad, *tabs, k,
                                        monotone=tabs.monotone,
                                        row_monotone=flags)

    mmin, _ = pass1_extrema(cpad, sdlam2, k)

    def b2(flags=rows):
        return pass2_min_cuda(mmin, sdphi2, po, k, row_monotone=flags)

    amin = b3()
    ref = min_haversine_param_from_padded(cpad, *tabs, k)
    err3 = bit_equal(amin, ref, f"{what} B3")
    bit_equal(b3(None), ref, f"{what} B3 without row flags")
    ref2 = pass2_min(mmin, sdphi2, po, k)
    err2 = bit_equal(b2(), ref2, f"{what} B2")
    bit_equal(b2(None), ref2, f"{what} B2 without row flags")
    bit_equal(b2(), amin, f"{what} B2 vs B3")
    h, w = amin.shape
    nwin = 2 * k + 1
    reach = int((amin < float(BIG) / 2).sum())
    cpl, group = pruned_layout()
    m_h, t_h, q_h, rows_h = (a.cpu().numpy() for a in (mmin, sdphi2, po,
                                                        rows))
    res = []
    for name, kernel, plain, skip, nbytes, pass1_ops, none in (
            ("B3", b3, lambda: min_haversine_param_from_padded(
                cpad, *tabs, k), True,
             4 * (cpad.numel() + h * w + (2 * h + w) * nwin) + h + w,
             2 * (h + 2 * k) * w, "none: no PyTorch call runs a masked "
             "min over a separable window"),
            ("B2", b2, lambda: pass2_min(mmin, sdphi2, po, k), False,
             4 * (mmin.numel() + h * w + 2 * h * nwin) + h, 0,
             "none: no single PyTorch call takes a min over a weighted lat "
             "window")):
        model, taps = pass2_centre_out(m_h, t_h, q_h, k, rows_h,
                                       band=32 * cpl, group=group,
                                       skip_empty=skip)
        least_out, least = pass2_least_taps(m_h, t_h, q_h, k, rows_h,
                                            skip_empty=skip)
        for out, model_name in ((model, "schedule"), (least_out, "least")):
            if not np.array_equal(out, amin.cpu().numpy()):
                raise AssertionError(f"{what} {name}: the host model's "
                                     f"({model_name}) output differs")
        all_ops = pass1_ops + 3 * nwin * reach
        res.append(dict(
            max_abs_err=err3 if name == "B3" else err2, k=k, call=kernel,
            taps_per_warp=float(taps.mean()), taps_max=int(taps.max()),
            least_taps=float(least.mean()), all_taps=nwin,
            all_taps_bound_ms=all_ops / PEAK_F32 * 1e3,
            **timing(kernel, plain, nbytes, pass1_ops + 3 * int(least.sum()),
                     library_note=none, plain_queued=True)))
    return res


def fmt_wide(t):
    return (f"{fmt_timing(t)}; taps a warp {t['taps_per_warp']:.1f} (most "
            f"{t['taps_max']}) of {t['all_taps']} in the host model of the "
            f"schedule, least taps a cell {t['least_taps']:.1f} (the "
            f"bound's); all-taps figure {t['all_taps_bound_ms'] * 1e3:.1f} "
            f"us")


def resident_run(world, impl, reps=1):
    """``TriggerPipeline(distance_impl=impl).run`` over a regional world with
    its inputs on the card: after a warm-up, ``reps`` runs, the launches of
    the first (B1 and the distance kernel once a step) and the median
    ms/step."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    T, nlat, nlon = theta.shape
    dev = torch.device("cuda")
    d = [torch.as_tensor(a, device=dev) for a in (theta, u, v, lsm, z, std,
                                                    pres, ci)]
    pipe = TriggerPipeline(grid, device=dev, distance_impl=impl)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pipe.run(TriggerState.zeros((nlat, nlon), dev), *d[:7],
                     ci_t=d[7])
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / T * 1e3

    run()                                       # warm-up
    zero_launches()
    result, first = run()
    launches = {n: c for n, c in read_launches().items() if c}
    kern = {"fused": "min_haversine", "hybrid": "pass2_min"}[impl]
    want = {kern: T, "ring_trigger_stacked": T}
    if launches != want:
        raise AssertionError(f"{impl} run launches {launches}, want {want}")
    times = [first] + [run()[1] for _ in range(reps - 1)]
    return dict(result=result, launches=launches,
                ms_per_step=float(np.median(times)))


def phase_wide(out):
    """The distance kernels past their old limits (B3 refused k > 354, B2
    raised for k > 175): B3's large build and B2's unstaged build alone at
    k = 387 and 620, bit-equal to plain and timed (:func:`wide_kernels`);
    ``diag`` on the 0.4 km world (k = 387) on the kernel path against plain
    (final ws/wd bit-equal); B1, B4 and B5 alone at its NN, B1 timed; and
    ``TriggerPipeline.run`` there with the hybrid distance (B2) against the
    fused one (B3), with each kernel's share of the fused run's step."""
    b3, b2, calls = {}, {}, {}
    for k, spacing in WIDE_WORLDS:
        t3, t2 = wide_kernels(wide_world(spacing), f"k={k}")
        if t3["k"] != k:
            raise AssertionError(f"wide world at {spacing}: k = {t3['k']}")
        b3[f"k{k}"], b2[f"k{k}"] = t3, t2
        calls[k] = {"B3 large": t3.pop("call"), "B2 unstaged": t2.pop("call")}
        log(f"# wide radius k={k} ({FINE_N}x{FINE_N} at {spacing} deg from "
            f"54 N): B3 large build bit-equal to plain (with and without "
            f"row flags), {fmt_wide(t3)}; B2 unstaged build bit-equal to "
            f"plain (with and without row flags), {fmt_wide(t2)} (plain: "
            f"events around calls)")
    k, spacing = WIDE_WORLDS[0]
    world = wide_world(spacing)
    dg = regional_diag(world, "0.4 km", 1)
    grid, (lsm, z, std, pres, theta, u, v, ci) = world
    T, nlat, nlon = theta.shape
    alone = ring_alone(world, dg["nn"], "0.4 km", step=T - 1)
    res, launches, ms = {}, {}, {}
    for impl in ("fused", "hybrid"):
        r = resident_run(world, impl)
        res[impl], launches[impl], ms[impl] = (r["result"], r["launches"],
                                               r["ms_per_step"])
    (fstate, fouts), (hstate, houts) = res["fused"], res["hybrid"]
    for key in fouts:
        bit_equal(houts[key], fouts[key], f"0.4 km hybrid vs fused {key}")
    for key, x in final_fields(hstate).items():
        bit_equal(x, final_fields(fstate)[key], f"0.4 km hybrid final {key}")
    # each kernel's device time a step over the fused run's ms/step
    shares = {"min_haversine_large": b3[f"k{k}"]["device_ms"] / ms["fused"],
              "ring_trigger_stacked_large": alone["b1"]["device_ms"]
              / ms["fused"]}
    log(f"# 0.4 km regional {nlat}x{nlon} at {spacing} deg (k={k}, NN="
        f"{dg['nn']}), {nvidia_smi()}: diag T={T} kernel path "
        f"{dg['ms_per_step']:.3f} ms/step, plain path "
        f"{dg['plain_ms_per_step']:.3f}; launches {dg['launches']}; matches "
        f"plain (max |diff| {dg['max_abs_err']:.3g}, final ws/wd "
        f"bit-equal); B1, B4, B5 bit-equal to plain on one step; B1 at NN="
        f"{dg['nn']} {fmt_timing(alone['b1'])} (plain: events around "
        f"calls); TriggerPipeline.run fused {ms['fused']:.3f} ms/step, "
        f"hybrid {ms['hybrid']:.3f}, launches {launches}, bit-equal; share "
        f"of the fused step: " + ", ".join(
            f"{n} {v:.3f}" for n, v in shares.items()))
    out.update(launches=dg["launches"], nn=dg["nn"],
               ms_per_step=dg["ms_per_step"],
               plain_ms_per_step=dg["plain_ms_per_step"],
               run_launches=launches, run_ms_per_step=ms, b3=b3, b2=b2,
               b1=alone["b1"], step_shares=shares, calls=calls[k])


#: The device kernels one call of each wide-radius build starts: B3's large
#: build the columns' monotone pieces, pass 1 and pass 2; B2's pass 2.
WIDE_KERNELS_A_CALL = {"B3 large": 3, "B2 unstaged": 1}


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs, as
    ``torch.profiler`` sees them (copies and fills left out), or None where
    it sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not seen:
        return None
    return [n for n in seen if not n.startswith(("Memcpy", "Memset"))]


def phase_nearest(out):
    """The nearest lon form (``TriggerPipeline(distance_lon_form=
    'nearest')``, whose ``'auto'`` on the card is the hybrid: torch pass 1
    by min-plus doubling, then B2) over the main world's 32 steps with its
    inputs on the card, against the plain path in the same form (per-step
    tolerance, final wind bit-equal), timed beside the taps' hybrid and the
    fused run in this process; then one step at 0.1 deg (1801 x 3600, k =
    15) against its plain path."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    dev = torch.device("cuda")

    def run(pipe, d, reps=1):
        T, nlat, nlon = d[0].shape
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = pipe.run(TriggerState.zeros((nlat, nlon), dev), *d[:7],
                         ci_t=d[7])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / T * 1e3)
        return r, float(np.median(times))

    res, worst, launches = {}, {}, {}
    for name in ("global025", "global010"):
        if name == "global025":
            grid, fields = main_world()
        else:
            from bench import make_world
            grid = world_grid(name)[0]
            fields = make_world(grid.nlat, grid.nlon, 4, 1, seed=3)
        lsm, z, std, pres, theta, u, v, ci = fields
        d = [torch.as_tensor(a, device=dev)
             for a in (theta, u, v, lsm, z, std, pres, ci)]
        T = theta.shape[0]
        pipes = {uk: TriggerPipeline(grid, device=dev, use_kernels=uk,
                                     distance_lon_form="nearest")
                 for uk in (None, False)}
        run(pipes[None], d)                     # warm-up
        zero_launches()
        (kstate, kout), kms = run(pipes[None], d)
        launches[name] = {n: c for n, c in read_launches().items() if c}
        want = {"pass2_min": T, "ring_trigger_stacked": T}
        if launches[name] != want:
            raise AssertionError(f"nearest {name} launches "
                                 f"{launches[name]}, want {want}")
        (pstate, pout), pms = run(pipes[False], d)
        worst[name] = check_fields({k: o.cpu() for k, o in kout.items()},
                                   {k: o.cpu() for k, o in pout.items()},
                                   f"nearest {name} per-step outputs")
        check_fields(final_fields(kstate), final_fields(pstate),
                     f"nearest {name} final state",
                     bit_state=("windspeed", "winddir"))
        sb = kout["sb_con"]
        if sb.shape != theta.shape or not torch.isfinite(sb).all():
            raise AssertionError(f"nearest {name}: sb_con shape or "
                                 f"finiteness")
        bits = all(torch.equal(kout[k], pout[k]) for k in kout)
        res[name] = dict(ms_per_step=kms, plain_ms_per_step=pms, T=T,
                         k=pipes[None].k, bit_equal=bits)
        if name == "global025":
            # the taps' hybrid and the fused run, in turns with the nearest
            others = {impl: TriggerPipeline(grid, device=dev,
                                            distance_impl=impl)
                      for impl in ("hybrid", "fused")}
            ms = {"nearest": [], "hybrid": [], "fused": []}
            for _ in range(3):
                for label, pipe in (("nearest", pipes[None]),
                                    *others.items()):
                    ms[label].append(run(pipe, d)[1])
            res[name]["turns_ms_per_step"] = {
                k: float(np.median(v)) for k, v in ms.items()}
    g, h = res["global025"], res["global010"]
    log(f"# nearest lon form (TriggerPipeline(distance_lon_form='nearest')"
        f".run, inputs resident): global025 T={g['T']} k={g['k']}: kernel "
        f"path {g['ms_per_step']:.3f} ms/step, plain "
        f"{g['plain_ms_per_step']:.3f}; launches {launches['global025']}; "
        f"matches plain (max "
        f"|diff| {worst['global025']:.3g}, final ws/wd bit-equal, all "
        f"outputs bit-equal: {g['bit_equal']}); median of 3 turns ms/step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    g["turns_ms_per_step"].items())
        + f"; global010 T={h['T']} k={h['k']}: kernel path "
        f"{h['ms_per_step']:.3f} ms/step, plain "
        f"{h['plain_ms_per_step']:.3f}, launches {launches['global010']}, "
        f"matches plain (max |diff| "
        f"{worst['global010']:.3g}, bit-equal: {h['bit_equal']})")
    out.update(res=res, launches=launches)


def two_extremum_inputs(grid, lsm, ci, k, dev):
    """B2's two-extremum inputs on one world's coastline at radius ``k``:
    pass 1's extrema (``need_max=True``), the grid's sdphi2 (its rows'
    flags set: they fall to the centre tap) and two po: drawn from [-1, 1]
    and the grid's own (>= 0)."""
    import torch
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, pad_coast, pass1_extrema)
    tabs = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci, device=dev))
    mmin, mmax = pass1_extrema(pad_coast(coast, k), tabs[2], k,
                               need_max=True)
    rng = np.random.default_rng(TWO_SEED + k)
    po = torch.as_tensor((2 * rng.random(tabs[1].shape) - 1).astype(
        np.float32), device=dev)
    return mmin, mmax, tabs[0], {"random": po, "grid": tabs[1]}, \
        tabs.row_monotone


def bits_equal(got, ref, what):
    """:func:`bit_equal` with signed zeros told apart."""
    import torch
    bit_equal(got.view(torch.int32), ref.view(torch.int32), what)
    return bit_equal(got, ref, what)


def phase_two_extremum(out):
    """B2's two-extremum form (``pass2_min_cuda(Mmax=)``), which no entry
    point takes: first as a standalone op on the 8 coupled steps' extrema
    with the grid's own tables (po >= 0), where it equals the single
    form's result bit for bit (its launches are the row's); then alone on
    the main world's coastline at each of :data:`TWO_RADII`, with po drawn
    from [-1, 1] (where the forms differ) and with the grid's po (where it
    equals the single form, bit for bit), each bit-equal to its plain
    version with the rows' flags and without; timed at :data:`TWO_TIMED`
    and at 0.1 deg (k = 15) with both po, the single form timed beside it
    on the grid's.  Its bound: bytes of Mmin, the tables, the output and
    only the padded rows of Mmax that a tap with po < 0 reaches (none with
    the grid's po); operations 3 a tap of the least taps any exact
    centre-out exit takes (``tools/pruned_model.py::pass2_two_floor_taps``,
    each cell leaving once its running minimum is its own minimum), not of
    the taps of the form's own exit on L (``pass2_two_least_taps``, whose
    output must equal the kernel's; printed beside it)."""
    import torch
    from bench import make_world
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda, pass2_min_two_limits)
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, effective_radius, pad_coast, pass1_extrema, pass2_min)
    from tools.pruned_model import pass2_two_floor_taps, pass2_two_least_taps
    dev = torch.device("cuda")
    grid, d = coupled_inputs(dev)
    k = effective_radius(grid, 180.0)
    tabs = device_tables(grid, k, dev)
    ext = []
    for s in range(len(COUPLED_STEPS)):
        cpad = pad_coast(get_edges(d["lsm"], d["ci"][s]), k)
        ext.append(pass1_extrema(cpad, tabs[2], k, need_max=True))
    zero_launches()
    two = [pass2_min_cuda(mn, tabs[0], tabs[1], k, Mmax=mx)
           for mn, mx in ext]
    launches = read_launches()["pass2_min_two"]
    if launches != len(ext):
        raise AssertionError(f"pass2_min_two launched {launches} times")
    for s, ((mn, _), got) in enumerate(zip(ext, two)):
        bits_equal(got, pass2_min_cuda(mn, tabs[0], tabs[1], k),
                   f"B2 two-extremum, coupled step {s}, vs the single form")

    staged = pass2_min_two_limits()
    if staged + 1 not in TWO_RADII or staged not in TWO_RADII:
        raise AssertionError(f"the two-extremum staged limit {staged} is "
                             f"not among {TWO_RADII}")
    none = ("none: no single PyTorch call takes a min over a weighted lat "
            "window")
    mgrid, (lsm, *_, ci) = main_world()
    res, errs = {}, {}
    for name, radii in (("global025", TWO_RADII), ("global010", (15,))):
        if name == "global010":
            mgrid = world_grid(name)[0]
            lsm, *_, ci = make_world(mgrid.nlat, mgrid.nlon, 1, 1, seed=3)
        for kk in radii:
            mn, mx, sd, pos, rows = two_extremum_inputs(
                mgrid, lsm, ci[0], kk, dev)
            for kind, po in pos.items():
                ref = pass2_min(mn, sd, po, kk, Mmax=mx)
                single = pass2_min_cuda(mn, sd, po, kk, row_monotone=rows)
                if kind == "grid":
                    bits_equal(ref, single, f"B2 two-extremum plain {name} "
                               f"k={kk}, grid po, vs the single form")
                # one column a window (k = 0) has Mmax = Mmin
                elif kk and not bool((ref < single).any()):
                    raise AssertionError(f"B2 two-extremum k={kk}: the "
                                         f"forms agree, so Mmax is not read")
                errs[name, kk, kind] = max(bits_equal(
                    pass2_min_cuda(mn, sd, po, kk, Mmax=mx, row_monotone=f),
                    ref, f"B2 two-extremum {name} k={kk} {kind} po")
                    for f in (rows, None))
                if name == "global025" and kk not in TWO_TIMED:
                    continue
                h, w = ref.shape
                nwin = 2 * kk + 1
                host = [a.cpu().numpy() for a in (mn, mx, sd, po)]
                ref_h = ref.cpu().numpy()
                least_out, least = pass2_two_least_taps(*host, kk)
                _, floor = pass2_two_floor_taps(*host, kk, amin=ref_h)
                if not np.array_equal(least_out, ref_h):
                    raise AssertionError(f"B2 two-extremum {name} k={kk}: "
                                         f"the host model's output differs")
                # Mmax is read only on the padded rows a tap with po < 0
                # reaches; Mmin, the tables and the output in full
                neg = torch.zeros(mn.shape[0], dtype=torch.bool, device=dev)
                ys, ds = torch.nonzero(po < 0, as_tuple=True)
                neg[ys + ds] = True
                hi_rows = int(neg.sum())
                entry = (name if kk in (6, 15) else f"k{kk}")
                entry = entry if kind == "random" else f"grid_{entry}"
                res[entry] = dict(
                    max_abs_err=errs[name, kk, kind], k=kk,
                    least_taps=float(least.mean()),
                    floor_taps=float(floor.mean()), all_taps=nwin,
                    mmax_rows=hi_rows, **timing(
                        lambda: pass2_min_cuda(mn, sd, po, kk, Mmax=mx),
                        lambda: pass2_min(mn, sd, po, kk, Mmax=mx),
                        4 * (mn.numel() + hi_rows * w + h * w
                             + 2 * h * nwin),
                        3 * int(floor.sum()), library_note=none,
                        plain_queued=nwin > 64))
                if kind == "grid":
                    res[entry]["single_ms"] = device_ms(
                        lambda: pass2_min_cuda(mn, sd, po, kk,
                                               row_monotone=rows))
    log(f"# B2 two-extremum: standalone on the {len(ext)} coupled steps "
        f"(k={k}, the grid's po >= 0): {launches} launches, bit-equal to "
        f"the single form; alone bit-equal to plain at "
        + ", ".join(f"{n} k={kk} {kind} po" for n, kk, kind in errs)
        + f" (staged to k = {staged}, with and without row flags; with the "
        f"grid's po bit-equal to the single form); "
        + "; ".join(f"{r} k={t['k']}: {fmt_timing(t)}; taps a cell: "
                    f"{t['floor_taps']:.1f} of {t['all_taps']} (any exact "
                    f"exit's least, the bound's), {t['least_taps']:.1f} "
                    f"(the exit on L's least); Mmax rows read "
                    f"{t['mmax_rows']}"
                    + (f"; single form {t['single_ms']:.4f} ms"
                       if "single_ms" in t else "")
                    for r, t in res.items()))
    out.update(launches=launches, res=res, staged=staged)


def strip_world():
    """STRIP_SHAPE cells 0.009 deg (1 km) apart from 54 N southward,
    STRIP_STEPS steps of ``bench.make_world`` fields (seed 3)."""
    from bench import make_world
    from seabreeze_param_tpu_torch.core.grid import Grid
    n, m = STRIP_SHAPE
    grid = Grid.regular(n, m, lat0=54.0, lat1=54.0 - (n - 1) * KM_SPACING,
                        lon0=0.0, lon1=m * KM_SPACING)
    return grid, make_world(n, m, 4, STRIP_STEPS, seed=3)


def phase_past_2047(out):
    """Ring radii past :data:`EXACT_NN`, where the float32 land count
    rounds: B1, B4 and B5 alone at :data:`PAST_NN` on a field of land cells
    all within maxdist (every cell runs to NN, latched on the rounded
    count), each bit-equal to its plain version and timed, beside the bound
    and the chain-work floor (``tools/ring_sweep_model.py::chain_floor``:
    the least additions a bit-equal schedule needs for these latch radii,
    over the float32 add rate :data:`PEAK_F32_ADD`); then ``diag`` on the strip world
    (:func:`strip_world`, k = 2200, NN = 2204: B1's sweep build and B3's
    large build) against its plain path; then the integral image of land
    that every B1, B4 and B5 launch from NN = 52 on starts with
    (``land_rows`` + ``land_cols``) alone at the strip's NN and at the 0.4
    km world's 391, bit-equal to plain and timed.  B1's share of the
    strip's step is read last (:func:`phase_strip_profile`)."""
    import torch
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
        StackedScan, land_image_cuda, land_image_plain, ring_thc_cuda_padded,
        ring_trigger_cuda_padded, ring_trigger_cuda_stacked)
    from tools.ring_sweep_model import chain_floor
    from seabreeze_param_tpu_torch.ops.ring_search import (
        ring_quantities, ring_thc_from_padded)
    from seabreeze_param_tpu_torch.ops.trigger import cadence, trigger_cells
    dev = torch.device("cuda")
    params = Params()
    h, w = PAST_FIELD
    none = "none: no PyTorch call runs an expanding-ring search"
    res = {}
    for nn in PAST_NN:
        rng = np.random.default_rng(nn)
        D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        cd_pad = D((50.0 + 100.0 * rng.random((h + 2 * nn, w + 2 * nn)))
                   .astype(np.float32))
        t0_pad = D((280.0 + 10.0 * rng.random(cd_pad.shape)).astype(
            np.float32))
        cd = cd_pad[nn:nn + h, nn:nn + w].contiguous()
        ws_new, wd_new, ws0, wd0 = (D(a) for a in (
            (5 + 3 * rng.random((h, w))).astype(np.float32),
            (360 * rng.random((h, w)) - 180).astype(np.float32),
            (5 + rng.random((h, w))).astype(np.float32),
            (360 * rng.random((h, w)) - 180).astype(np.float32)))
        flags = cadence(15, params)
        ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                            *flags, params, nn)
        scan = StackedScan(h, w, params, dev)
        bufs = scan.init_buffers(1, ws0, wd0)
        ever = scan.add_coastal(cd)
        ws_s, wd_s = ws0.clone(), wd0.clone()

        def b1():
            ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new,
                                      ws_s, wd_s, *flags, params, nn, 0,
                                      *bufs, ever)

        def b4():
            return ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new,
                                            wd_new, ws0, wd0, *flags, params,
                                            nn)

        def b5():
            return ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)

        def b5_plain():
            return ring_thc_from_padded(
                ring_quantities(t0_pad, cd_pad),
                torch.where(cd >= 0, 1.0, -1.0), nn,
                coastal=cd.abs() <= float(np.float32(params.maxdist)))[0]

        def plain():
            return trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad,
                                 cd_pad, *flags, params, nn)

        b1()
        err1 = max(bit_equal(b[0], r, f"NN={nn} B1 {f}")
                   for b, r, f in zip(bufs, ref, ("sb", "ws", "wd")))
        err4 = max(bit_equal(g, r, f"NN={nn} B4 {f}") for g, r, f in zip(
            b4(), (ref[0], ref[3], ref[4]), ("sb", "ws", "wd")))
        err5 = bit_equal(b5(), b5_plain(), f"NN={nn} B5")
        unit = tile_mask(cd, params.maxdist)
        _, cells, adds = ring_work(cd_pad, cd, nn, params.maxdist, unit)
        # the least additions a bit-equal schedule needs for these latch
        # radii: the chains each taken to the greatest order a window reads
        floor = chain_floor(latch_radius(cd_pad, cd, nn, params.maxdist)
                            .cpu().numpy(), nn)
        floor_ms = floor["adds"] / PEAK_F32_ADD * 1e3
        # every tile is coastal, so the windows read the whole padded pair:
        # B1 reads it and the five other fields, and writes five
        pad_bytes = 4 * (t0_pad.numel() + cd_pad.numel())
        for key, err, fn, ref_fn, nbytes in (
                (f"nn{nn}", err1, b1, plain,
                 pad_bytes + 40 * cells + unit.numel()),
                (f"b4_nn{nn}", err4, b4, plain, pad_bytes + 32 * h * w),
                (f"b5_nn{nn}", err5, b5, b5_plain, pad_bytes + 8 * h * w)):
            t = timing(fn, ref_fn, nbytes, adds, library_note=none,
                       plain_queued=True)
            res[key] = dict(max_abs_err=err, nn=nn, **t, floor_ms=floor_ms,
                            floor_adds=floor["adds"],
                            share_of_floor=floor_ms / t["device_ms"])

    grid, (lsm, z, std, pres, theta, u, v, ci) = strip_world()
    T, nlat, nlon = theta.shape
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = diag(*args, device="cuda", full_output=True,
                 maxdist=STRIP_MAXDIST, **kw)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / T * 1e3

    zero_launches()
    kern, kms = run()
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"ring_trigger_stacked": T, dist_kernel(): T + 1}  # + the probe
    if launches != want:
        raise AssertionError(f"strip diag launches {launches}, want {want}")
    nn = diag_nn(grid)
    if nn <= EXACT_NN:
        raise AssertionError(f"strip diag ran at NN = {nn} <= {EXACT_NN}")
    plain, pms = run(use_kernels=False)
    worst = check_fields(kern[5], plain[5], "strip diag per-step outputs")
    check_fields(dict(thc=kern[2], windspeed=kern[3], winddir=kern[4]),
                 dict(thc=plain[2], windspeed=plain[3], winddir=plain[4]),
                 "strip diag final state", bit_state=("windspeed", "winddir"))
    sb = kern[1]
    if sb.shape != (T, nlat, nlon) or not np.isfinite(sb).all():
        raise AssertionError("strip diag: sb_con shape or finiteness")
    # the integral image of land alone: read cd_pad, write the image
    image = {}
    for key, (ph, pw) in ((f"strip_nn{nn}", (nlat + 2 * nn, nlon + 2 * nn)),
                          ("wide_nn391", (FINE_N + 782, FINE_N + 782))):
        gen = torch.Generator(device=dev).manual_seed(ph)
        cdp = torch.rand((ph, pw), generator=gen, device=dev) - 0.5
        err = bit_equal(land_image_cuda(cdp), land_image_plain(cdp),
                        f"land image {key}")
        image[key] = dict(max_abs_err=err, shape=(ph, pw), **timing(
            lambda cdp=cdp: land_image_cuda(cdp),
            lambda cdp=cdp: land_image_plain(cdp),
            4 * ph * pw + 4 * (ph + 1) * (pw + 1), 2 * ph * pw,
            library_note="torch.cumsum twice is the plain version"))
    log(f"# ring radii past {EXACT_NN} ({h}x{w} land within maxdist, every "
        f"cell to NN): B1, B4, B5 bit-equal to plain at NN = "
        + ", ".join(str(n) for n in PAST_NN) + "; "
        + "; ".join(f"{r} {fmt_timing(t)}, chain-work floor "
                    f"{t['floor_ms']:.4f} ms ({t['floor_adds']} adds), share "
                    f"{t['share_of_floor']:.3f}" for r, t in res.items())
        + f"; diag on {nlat}x{nlon} at {KM_SPACING} deg from 54 N, maxdist "
        f"{STRIP_MAXDIST:g} km (NN={nn}), T={T}: kernel path {kms:.3f} "
        f"ms/step, plain {pms:.3f} (probe included, no warm-up); launches "
        f"{launches}; matches plain (max |diff| {worst:.3g}, final ws/wd "
        f"bit-equal), sb missing fraction {float((sb == MISSING).mean()):.4f}"
        "; integral image of land alone (land_rows + land_cols), bit-equal "
        "to plain: " + "; ".join(f"{k} {v['shape'][0]}x{v['shape'][1]} "
                                 f"{fmt_timing(v)}" for k, v in image.items()))
    out.update(res=res, launches=launches, nn=nn, ms_per_step=kms,
               plain_ms_per_step=pms, image=image, T=T,
               strip_call=lambda: run())


def phase_strip_profile(past):
    """B1's device time inside one kernel-path ``diag`` call on the strip
    world (:func:`phase_past_2047`), under ``torch.profiler``: the sum of
    its kernels' device times (the integral image and the sweep build's
    kernels; last of the phases, with :func:`phase_kernels_a_call`, so that
    no timed phase runs after the profiler), a step's worth beside the
    unprofiled run's ms/step.  "not measured" where the profiler sees no
    device activity."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = past.pop("strip_call")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in kern if re.search(r"sweep_\w+|land_(rows|cols)",
                                         e.name)]
    if not kern:
        log("# strip diag under torch.profiler: B1's device time not "
            "measured (the profiler saw no device activity)")
        return
    b1_ms = sum(e.device_time for e in mine) / 1e3 / past["T"]
    past["strip_b1"] = dict(device_ms_per_step=b1_ms,
                            share=b1_ms / past["ms_per_step"],
                            kernels=len(mine))
    log(f"# strip diag (NN={past['nn']}) under torch.profiler: B1's kernels "
        f"(land_rows, land_cols, sweep_*) {b1_ms:.3f} ms of device time a "
        f"step ({len(mine)} kernels in {past['T']} steps), "
        f"{past['strip_b1']['share']:.3f} of the unprofiled run's "
        f"{past['ms_per_step']:.3f} ms/step")


def phase_kernels_a_call(wide):
    """The kernels a call of B3's large build and of B2's unstaged build
    starts at the 0.4 km world's k, counted under ``torch.profiler`` (last
    of the phases, so that no timed phase runs after the profiler).  Fails
    where the count differs from :data:`WIDE_KERNELS_A_CALL`."""
    import re
    counts = {}
    for name, fn in wide.pop("calls").items():
        seen = device_kernels(fn)
        if seen is None:
            counts[name] = ("not measured (the profiler saw no device "
                            "activity)")
            continue
        if len(seen) != WIDE_KERNELS_A_CALL[name]:
            raise AssertionError(f"{name}: a call ran {len(seen)} device "
                                 f"kernels: {seen}")
        short = [m.group(1) if m else n[:40] for m, n in (
            (re.search(r"(\w+)(?:<[^>]*>)?\(", n), n) for n in seen)]
        counts[name] = f"{len(seen)} ({', '.join(short)})"
    log(f"# wide radius k={WIDE_WORLDS[0][0]}: device kernels a call under "
        f"torch.profiler: " + "; ".join(f"{n} {c}" for n, c in counts.items()))


def spawn_ranks(case, tmp, *args):
    """``chip_smoke.py --rank case tmp args`` in MP_RANKS processes over
    gloo on the one card, with the launcher variables torchrun sets; each
    rank's JSON result.  Every process is stopped before this returns, and
    a rank that fails or outlasts MP_TIMEOUT fails the phase."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(MP_RANKS))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", case, tmp,
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(MP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"multiprocess {case}: rank {r} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")
    results = []
    for r in range(MP_RANKS):
        with open(os.path.join(tmp, f"{case}.{r}.json")) as f:
            results.append(json.load(f))
    return results


def rank_driver(conf, res, what, ref, days, **kw):
    """One rank's batch driver run over ``conf`` on the global 2 x 4 mesh:
    rank 0 writes the files, which must be bit-equal to ``ref``'s files
    ``days``, the other ranks none; the final state bit-equal to
    ``ref``'s where the run ends with the series."""
    import torch
    from seabreeze_param_tpu_torch.cli import run
    from seabreeze_param_tpu_torch.io import Dataset
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt, thc, ws, wd, written = run.main(conf, progress=None, device="cuda",
                                        mesh=SHARD_MESH, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in read_launches().items() if c}
    if not {"halo_exchange", "ring_trigger_stacked", dist_kernel()} <= set(
            launches):
        raise AssertionError(f"{what}: launches {launches}")
    if len(written) != (len(days) if dist.rank() == 0 else 0):
        raise AssertionError(f"{what}: rank {dist.rank()} wrote {written}")
    for path, day in zip(written, days):
        with Dataset(path) as f:
            for key in ("sb_con", "thc"):
                if not np.array_equal(np.ma.getdata(f.variables[key][:]),
                                      ref[f"{day}_{key}"]):
                    raise AssertionError(f"{what}: file {day} {key} not "
                                         f"bit-equal to one process's")
        os.remove(path)
    if tt != 1 + (days[-1] + 1) * DRIVER_STEPS:
        raise AssertionError(f"{what}: tt {tt}")
    if days[-1] == DRIVER_DAYS - 1:
        for name, x in (("thc", thc), ("ws", ws), ("wd", wd)):
            if not np.array_equal(x, ref[name]):
                raise AssertionError(f"{what}: final {name} not bit-equal")
    res[what] = dict(launches=launches, tt=tt, files=len(written),
                     ms_per_step=secs / (len(days) * DRIVER_STEPS) * 1e3)


def rank_runner(runner, d, rout, rstate, what):
    """One rank's ``DistributedRunner`` on its rows of the resident inputs
    ``d`` (the main world's first SHARD_STEPS steps), once to warm up and
    once with the launch counts zeroed just before: the launches (B6
    once a group an exchange), bit-equal to one process's run ``rout`` /
    ``rstate`` on the same global mesh; returns what it measured, and the
    block's outputs."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    mesh, T = runner.sp.mesh, SHARD_STEPS
    nlat, nlon = runner.sp.nlat_real, d[3].shape[-1]
    if not runner.sp.overlap:
        raise AssertionError(f"{what}: not the overlapped structure")
    lo, hi = runner.row_lo, min(runner.row_hi, nlat)
    local = [x if x.dim() == 1 else x[..., lo:hi, :].contiguous()
             for x in d]

    def go():
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = runner.run(TriggerState.zeros((hi - lo, nlon), d[3].device),
                       *local[:7], ci_t=local[7])
        torch.cuda.synchronize()
        dist.barrier()
        return r, (time.perf_counter() - t0) / T * 1e3

    go()                                        # warm-up
    zero_launches()
    (fin, outs), ms = go()
    launches = {n: c for n, c in read_launches().items() if c}
    want = {"halo_exchange": mesh.groups * (3 + 2 * T),
            "ring_trigger_stacked": mesh.size * T,
            dist_kernel(): mesh.size * T}
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, want {want}")
    for key in outs:
        bit_equal(outs[key], rout[key][:, lo:hi], f"{what} {key}")
    for key, x in final_fields(fin).items():
        bit_equal(x, final_fields(rstate)[key][lo:hi], f"{what} final {key}")
    return dict(launches=launches, ms_per_step=ms, rows=[lo, hi],
                local_mesh=list(mesh.shape), groups=mesh.groups), outs


def rank_groups(res, single, d):
    """Part of :func:`rank_run`: each rank's block of the global meshes
    MP_GROUP_MESHES over MP_GROUPS groups of the one card (as a JAX process
    holds several devices), ``DistributedRunner`` bit-equal to one process
    on the same global mesh and to one group a rank; then B6 with process
    edges over the groups alone (theta's NN-wide exchange on the 2 x 4
    global mesh, whose 1 x 4 block puts one mesh row across both groups, so
    both read both edges): bit-equal to its plain version and to the
    exchange with the trade, timed on the device (one rank at a time) and
    by call with the trade (both ranks at once), beside its bounds."""
    import torch
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.ops.cuda import halo_kernel
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.halo import (halo_exchange_plain,
                                                         halo_pad)
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh, split
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline
    dev = d[3].device
    nlat, nlon = d[3].shape
    for shape in MP_GROUP_MESHES:
        rstate, rout = ShardedPipeline(single, make_mesh(shape, dev)).run(
            TriggerState.zeros((nlat, nlon), dev), *d[:7], ci_t=d[7])
        runs, outs = {}, {}
        for label, devices in (("groups", [dev] * MP_GROUPS),
                               ("one_group", dev)):
            runs[label], outs[label] = rank_runner(
                dist.DistributedRunner(ShardedPipeline(
                    single, dist.make_multihost_mesh(shape, devices))),
                d, rout, rstate, f"{shape} {label}")
        for key, x in outs["groups"].items():
            bit_equal(x, outs["one_group"][key],
                      f"{shape} groups vs one group a rank {key}")
        res[f"groups_{shape}"] = runs

    mesh = dist.make_multihost_mesh("2x4", [dev] * MP_GROUPS)
    flat = dist.make_multihost_mesh("2x4", dev)
    nn = single.nn_max
    h, w = -(-nlat // mesh.global_shape[0]), nlon // mesh.px
    gen = torch.Generator(device=dev).manual_seed(6 + dist.rank())
    field = torch.randn((mesh.py * h, nlon), generator=gen, device=dev)
    local = split(field, mesh)
    kw = dict(lat_fill="clamp", exact_lon=False)
    edges = dist.exchange_edges(local, mesh, nn)
    if set(edges) != {dev}:
        raise AssertionError(f"process edges delivered to {set(edges)}")

    def kernel():
        return halo_kernel.halo_exchange_cuda(local, mesh, nn, nn,
                                              edges=edges, **kw)

    def plain():
        return halo_exchange_plain(local, mesh, nn, nn, edges=edges, **kw)

    def traded():
        return halo_pad(local, mesh, nn, nn, **kw)

    got = kernel()
    take = halo_take(local, mesh, nn, kw, edges)
    bit_equal(take(), torch.stack(got), "B6 process edges over groups vs "
                                        "its torch.take yardstick")
    for s, (g, p, t, f) in enumerate(zip(
            got, plain(), traded(),
            halo_pad(split(field, flat), flat, nn, nn, **kw))):
        bit_equal(g, p, f"B6 process edges over groups, shard {s}, vs plain")
        bit_equal(g, t, f"B6 process edges over groups, shard {s}, vs the "
                        f"exchange with the trade")
        bit_equal(g, f, f"B6 process edges over groups, shard {s}, vs one "
                        f"group a rank")
    # the card's bytes: sources and the edge strips read once, padded blocks
    # written once; the host link's: each edge sent and received once
    strip = 4 * nn * nlon
    sends = sum(1 for peer in (dist.rank() - 1, dist.rank() + 1)
                if 0 <= peer < dist.world_size())
    card = 4 * mesh.size * (h * w + (h + 2 * nn) * (w + 2 * nn)) \
        + strip * sends
    link = 2 * strip * sends
    t = None
    for r in range(dist.world_size()):          # the device to one rank
        dist.barrier()
        if dist.rank() == r:
            t = timing(kernel, plain, card, 0, library=take,
                       library_note="torch.take of the stacked shards and "
                                    "edge strips")
            torch.cuda.synchronize()
        dist.barrier()
    calls = {}
    for name, fn in (("trade_call_ms", traded),
                     ("edges_call_ms", lambda: dist.exchange_edges(
                         local, mesh, nn))):
        fn()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MP_TRADES):
            fn()
        torch.cuda.synchronize()
        calls[name] = (time.perf_counter() - t0) / MP_TRADES * 1e3
    t.update(**calls,
             trade_bound_ms=(link / PEAK_HOST_LINK
                             + card / PEAK_BYTES) * 1e3,
             host_link_bytes=link, groups=mesh.groups, max_abs_err=0.0,
             nn=nn, smi=nvidia_smi())
    res["b6_process_edges"] = t


def rank_run(tmp, res, conf, conf2, ck):
    """One rank of :func:`phase_multiprocess`'s first launch: the
    references of one process first, then, in the group,
    ``DistributedRunner`` on the main world's first SHARD_STEPS steps over
    the global 2 x 4 mesh (resident inputs, each rank its rows), ``diag(
    mesh='2x4')`` from host arrays, the batch driver over the series, and
    the driver's first two days under ``ck``."""
    import torch
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    dev = torch.device("cuda")
    grid, (lsm, z, std, pres, theta, u, v, ci) = main_world()
    nlat, nlon = grid.shape
    T = SHARD_STEPS
    d = [torch.as_tensor(a, device=dev) for a in
         (theta[:T], u[:T], v[:T], lsm, z, std, pres, ci[:T])]
    single = TriggerPipeline(grid, device=dev)
    # one process's 2 x 4 run and diag, before the group exists
    rstate, rout = ShardedPipeline(single, make_mesh(SHARD_MESH, dev)).run(
        TriggerState.zeros((nlat, nlon), dev), *d[:7], ci_t=d[7])
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u[:T], v[:T],
            theta[:T], ci[:T])
    rdiag = diag(*args, device="cuda", full_output=True, mesh=SHARD_MESH)

    dist.initialize()
    if dist.world_size() != MP_RANKS:
        raise AssertionError(f"world size {dist.world_size()}")
    mesh = dist.make_multihost_mesh(SHARD_MESH, dev)
    res["runner"] = rank_runner(dist.DistributedRunner(
        ShardedPipeline(single, mesh)), d, rout, rstate, "runner")[0]
    rank_groups(res, single, d)

    # diag over the rank's card, and over MP_GROUPS groups of it
    for what, device in (("diag", "cuda"), ("diag_groups", [dev] * MP_GROUPS)):
        groups = 1 if device == "cuda" else MP_GROUPS
        diag(*args, device=device, full_output=True, mesh=SHARD_MESH)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = diag(*args, device=device, full_output=True, mesh=SHARD_MESH)
        torch.cuda.synchronize()
        dms = (time.perf_counter() - t0) / T * 1e3
        dlaunches = {n: c for n, c in read_launches().items() if c}
        want = {"halo_exchange": groups * (3 + 2 * T),
                "ring_trigger_stacked": mesh.size * T,
                dist_kernel(): mesh.size * T + 1}      # + the ring probe
        if dlaunches != want:
            raise AssertionError(f"{what} launches {dlaunches}, want {want}")
        if got[0] != rdiag[0]:
            raise AssertionError(f"{what}: tt differs")
        for i in range(1, 5):
            if not np.array_equal(got[i], rdiag[i]):
                raise AssertionError(f"{what}: return {i} not bit-equal")
        for key in rdiag[5]:
            if not np.array_equal(got[5][key], rdiag[5][key]):
                raise AssertionError(f"{what}: {key} not bit-equal")
        res[what] = dict(launches=dlaunches, ms_per_step=dms)

    ref = np.load(os.path.join(tmp, "driver_ref.npz"))
    rank_driver(conf, res, "driver", ref, list(range(DRIVER_DAYS)))
    rank_driver(conf2, res, "driver_first_two_days", ref, [0, 1],
                ckpt_dir=ck)


def rank_resume(tmp, res, conf, ck):
    """One rank of :func:`phase_multiprocess`'s relaunch: the series under
    the first launch's checkpoint directory resumes at day 3."""
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    dist.initialize()
    ref = np.load(os.path.join(tmp, "driver_ref.npz"))
    rank_driver(conf, res, "resume", ref, [DRIVER_DAYS - 1], ckpt_dir=ck)


def rank_main(case, tmp, *args):
    """One rank of the multi-process phase (``--rank``): runs ``case`` and
    writes its JSON result into ``tmp``."""
    import torch
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    res = {}
    {"run": rank_run, "resume": rank_resume}[case](tmp, res, *args)
    res.update(rank=dist.rank(), device=str(torch.cuda.current_device()))
    dist.barrier()
    with open(os.path.join(tmp, f"{case}.{dist.rank()}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_multiprocess(out):
    """The multi-process run: MP_RANKS ranks over gloo sharing the one
    card (halos and statistics through host memory), as subprocesses given
    the launcher variables.  One process computes the references here and
    in each rank; the ranks hold ``DistributedRunner`` (B6 + B3 + B1),
    ``diag(mesh='2x4')`` and the batch driver bit-equal to them, only
    rank 0 writing files; a relaunch resumes from the first launch's
    checkpoint.  Each rank also holds its block over MP_GROUPS groups of
    the card, as a JAX process holds several devices
    (:func:`rank_groups`: the runner on the 2 x 4 and 4 x 2 global meshes
    bit-equal to one process and to one group a rank, B6's process edges
    over the groups timed; ``diag`` over the groups).  Each rank counts
    its own launches."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="sb_mp_")
    try:
        conf, conf2 = write_series(tmp)
        (tt, thc, ws, wd), files = driver_run(conf, mesh=SHARD_MESH)
        np.savez(os.path.join(tmp, "driver_ref.npz"), tt=tt, thc=thc, ws=ws,
                 wd=wd, **{f"{i}_{key}": x for i, f in enumerate(files)
                           for key, x in f.items()})
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        run = spawn_ranks("run", tmp, conf, conf2, ck)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = spawn_ranks("resume", tmp, conf, ck)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for part in ("runner", "diag", "diag_groups", "driver"):
        log(f"# multiprocess {part} ({MP_RANKS} ranks over gloo on one card, "
            f"global mesh {SHARD_MESH}): " + "; ".join(
                f"rank {res['rank']} {res[part]['ms_per_step']:.3f} ms/step, "
                f"launches {res[part]['launches']}" for res in run)
            + "; bit-equal to one process")
    smi = nvidia_smi()
    for shape in MP_GROUP_MESHES:
        log(f"# multiprocess groups ({MP_RANKS} ranks over gloo on one card "
            f"[{smi}], global mesh {shape}, each rank's "
            f"{run[0][f'groups_{shape}']['groups']['local_mesh']} block "
            f"over {MP_GROUPS} groups of the card, T={SHARD_STEPS}): "
            + "; ".join(
                f"rank {res['rank']} groups {g['groups']['ms_per_step']:.3f}"
                f" ms/step (B6 launches "
                f"{g['groups']['launches']['halo_exchange']}), one group a "
                f"rank {g['one_group']['ms_per_step']:.3f} (B6 launches "
                f"{g['one_group']['launches']['halo_exchange']})"
                for res in run for g in (res[f"groups_{shape}"],))
            + "; bit-equal to one process and to one group a rank")
    for res in run:
        t = res["b6_process_edges"]
        log(f"# multiprocess B6 process edges over {t['groups']} groups, "
            f"rank {res['rank']} [{t['smi']}], theta's NN={t['nn']} exchange "
            f"of its 1 x 4 block of the 2 x 4 global025 mesh: bit-equal to "
            f"plain, to the exchange with the trade and to one group a rank; "
            f"launches alone {fmt_timing(t)}; with the trade over gloo "
            f"{t['trade_call_ms'] * 1e3:.1f} us a call (the trade alone, "
            f"exchange_edges, {t['edges_call_ms'] * 1e3:.1f} us), bound "
            f"{t['trade_bound_ms'] * 1e3:.2f} us ({t['host_link_bytes']} "
            f"bytes over the host link at {PEAK_HOST_LINK / 1e9:g} GB/s)")
    log(f"# multiprocess resume: " + "; ".join(
        f"rank {res['rank']} wrote {res['resume']['files']} file(s), tt "
        f"{res['resume']['tt']}" for res in resume)
        + f"; runner rows {[res['runner']['rows'] for res in run]}; "
        f"{run_s:.1f} s and {resume_s:.1f} s for the two launches")
    out.update(run=run, resume=resume, launch_s=[run_s, resume_s])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import bench  # noqa: F401  (the world generator; fails outside the repo)
    import seabreeze_param_tpu_torch.api  # noqa: F401

    log(nvidia_smi())
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    b2, b1, padded, main_out = {}, {}, {}, {}
    coupling, fused, dummy = {}, {}, {}
    b6, sharded, diag_mesh, dummy_sharded, driver = {}, {}, {}, {}, {}
    fine, km, wide, multiprocess = {}, {}, {}, {}
    nearest, two, past, multicard = {}, {}, {}, {}
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
    phase_fine(fine)
    phase_km(km)
    phase_wide(wide)
    phase_past_2047(past)
    phase_nearest(nearest)
    phase_two_extremum(two)
    phase_sharded(sharded)
    phase_diag_mesh(diag_mesh)
    phase_dummy_sharded(dummy_sharded)
    phase_multicard(multicard)
    phase_driver(driver)
    phase_multiprocess(multiprocess)
    phase_kernels_a_call(wide)
    phase_strip_profile(past)

    def per_kernel(name):
        return {g: padded[g][name] for g in padded}

    src = "seabreeze_param_tpu_torch/csrc/"
    pal = "seabreeze_param_tpu/ops/pallas/"
    # the numbers measured in this run, the bound computed from its
    # inputs, and the size's radii; derived figures (shares, B1's coastal
    # fraction, modelled taps) stay in the log lines above
    keys = ("max_abs_err", "device_ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library", "nn", "k", "hybrid_ms",
            "groups", "cards", "peer_path", "group_device_ms",
            "trade_call_ms", "edges_call_ms", "trade_bound_ms", "single_ms")
    kernels = []

    def dist_row(name, impl):
        """Launches and path of a distance kernel: the main path's where
        ``'auto'`` takes it, else the fused phase's run of ``impl``."""
        if dist_kernel() == name:
            return main_out["launches"][name], "main path: diag"
        return (fused["launches"][impl][name],
                f"TriggerPipeline(distance_impl='{impl}').run")

    b3_meas = {**per_kernel("min_haversine"), "fine": fine["b3"],
               "km": km["b3"]}
    for name, cu, replaces, meas, launches, path in (
            ("pass2_min", "pass2_min.cu", "distance_kernel.py:233", b2,
             *dist_row("pass2_min", "hybrid")),
            ("ring_trigger_stacked", "ring_trigger.cu", "ring_kernel.py:694",
             b1, main_out["launches"]["ring_trigger_stacked"],
             "main path: diag"),
            ("min_haversine", "min_haversine.cu", "distance_kernel.py:93",
             b3_meas, *dist_row("min_haversine", "fused")),
            ("ring_trigger_padded", "ring_trigger.cu", "ring_kernel.py:837",
             per_kernel("ring_trigger_padded"),
             coupling["launches"]["ring_trigger_padded"],
             "coupling: CoupledTrigger.physics"),
            ("ring_thc", "ring_trigger.cu", "ring_kernel.py:194",
             per_kernel("ring_thc"), coupling["b5_launches"],
             "standalone op on the coupled steps"),
            ("halo_exchange", "halo_exchange.cu", "halo_kernel.py:183",
             {**b6, "multicard": multicard["b6"],
              "multiprocess_groups": multiprocess["run"][0][
                  "b6_process_edges"]},
             sharded["launches"]["overlap"]["halo_exchange"],
             f"sharded: ShardedPipeline.run on {SHARD_MESH}, overlapped"),
            ("ring_trigger_stacked_large", "ring_trigger.cu",
             "ring_kernel.py:694",
             {"fine": fine["b1"], "km": km["b1"], "wide": wide["b1"]},
             fine["launches"]["ring_trigger_stacked"],
             f"fine regional diag, NN = {fine['nn']} >= "
             f"{fine['large_from']}: B1's large build (km: the 1 km "
             f"world's diag, NN = {km['nn']}, {km['launches']}; wide: the "
             f"0.4 km world's, NN = {wide['nn']}, {wide['launches']})"),
            ("ring_trigger_padded_large", "ring_trigger.cu",
             "ring_kernel.py:837", {"fine": fine["b4"]},
             fine["coupled_launches"]["ring_trigger_padded"],
             f"fine regional coupled step, NN = {fine['coupled_nn']}: B4's "
             f"large build"),
            ("min_haversine_large", "min_haversine.cu",
             "distance_kernel.py:93", wide["b3"],
             wide["launches"]["min_haversine"],
             f"0.4 km regional diag (k = {WIDE_WORLDS[0][0]}, NN = "
             f"{wide['nn']}): B3's large build (k620: alone at k = 620)"),
            ("pass2_min_unstaged", "pass2_min.cu", "distance_kernel.py:233",
             wide["b2"], wide["run_launches"]["hybrid"]["pass2_min"],
             f"TriggerPipeline(distance_impl='hybrid').run on the 0.4 km "
             f"world (k = {WIDE_WORLDS[0][0]}): B2's unstaged build (k620: "
             f"alone at k = 620)"),
            ("pass2_min_two", "pass2_min.cu", "distance_kernel.py:233",
             two["res"], two["launches"],
             f"standalone op on the coupled steps (no entry point takes the "
             f"two-extremum form): pass2_min_cuda(Mmax=); alone with po in "
             f"[-1, 1] at k = 6 (global025), 15 (global010), "
             + ", ".join(str(x) for x in TWO_TIMED[1:])
             + f" (staged to k = {two['staged']}); grid_*: the grid's po, "
             f"single_ms the single form on the same extrema"),
            ("ring_trigger_stacked_past_2047", "ring_trigger.cu",
             "ring_kernel.py:694", past["res"],
             past["launches"]["ring_trigger_stacked"],
             f"diag on the {STRIP_SHAPE[0]} x {STRIP_SHAPE[1]} strip world, "
             f"maxdist {STRIP_MAXDIST:g} km, NN = {past['nn']}: B1's sweep "
             f"build past NN = {EXACT_NN} (alone: B1 nn*, B4 b4_nn*, B5 "
             f"b5_nn* on {PAST_FIELD[0]} x {PAST_FIELD[1]} land)")):
        first, *rest = meas
        m = {key: meas[first][key] for key in keys if key in meas[first]}
        # ``ms`` is the line's name for the kernel's device time
        kernels.append(dict(
            name=name, route="cuda", source=src + cu, replaces=pal + replaces,
            launches=launches, ms=m["device_ms"], **m, shape=first, path=path,
            **{r: {key: meas[r][key] for key in keys if key in meas[r]}
               for r in rest}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(*sys.argv[2:]))
    sys.exit(main())
