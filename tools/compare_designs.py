#!/usr/bin/env python3
"""Time the designs of kernels B1, B2, B3, B4, B5 and B6 side by side on
one NVIDIA GPU.

    python3 tools/compare_designs.py [--against NAME=DIR ...] [--reps N]
                                     [--only B1,B2,B3,B4,B5,B6,B2two]
                                     [--builds NAME,...]

Builds, with one ``nvcc`` per library, all started together:

* ``this``: the port's kernels, ``seabreeze_param_tpu_torch/csrc/
  {ring_trigger,pass2_min,min_haversine,halo_exchange}.cu``
  (``ring_trigger.cu`` also serves B4 and B5);
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
  32 x 32 tiles of two cells per thread, and both;
* B1/B4/B5 ``large``: ``ring_trigger.cu`` with every NN on its large build
  (``-DSBZ_RING_LARGE_FROM=1``), which the port takes from NN = 52;
* B1/B4/B5 ``sweep``: ``ring_trigger.cu`` with the sweep build, which the
  port takes past NN = 2047, from NN = 52 on (``-DSBZ_RING_SWEEP_FROM=52``),
  timed beside the large build at the fine, 1 km and 0.4 km worlds;
* B1/B4/B5 ``sweep_first``: ``tools/designs/ring_trigger_sweep_first.cu``,
  the sweep build's first design (hp cells staged anew every chunk, vc
  warps of 8 rows loading their own cells, a window a radius at a time),
  past NN = 2047;
* B1/B4/B5 ``no_vc_stage``, ``no_corners``, ``land_chains``, ``first``,
  ``staged_2block``, ``unstaged`` and ``image_2block``:
  ``tools/designs/ring_trigger_large_variants.cu``, the large build with
  the entering vc columns' cells read through L1; with that and the
  per-radius steps' cells read through L1 too; with the land channel
  summed as integer chains beside the sums instead of an integral image
  (the latch found during the sweep, a vote per radius, no corner squares,
  no vc staging); the same with every cell read through L1 and two blocks
  per SM (the first design), with two blocks per SM, with the entering hp
  rows read through L1; and the port's held to two blocks per SM;
* B3 ``first``: ``tools/designs/min_haversine_variants.cu`` design 0, the
  port's first design (one block per 16 x 32 tile staging its whole strip;
  it refuses k >= 89); ``sweep1``, ``sweep1_taps``, ``sweep1_no_early``,
  ``sweep1_waves1``, ``sweep1_waves4`` and ``sweep1_nbuf2``: design 1, the
  first sweep (the band's sdlam2 columns in shared memory, the pass-2
  tables through L1, per-row sdphi2 flags and an early stop of pass 2),
  and the same with pass 1 by the tap loop instead of the coast bits,
  with every pass-2 tap in order, with chunks filling the resident block
  slots once or four times over instead of twice, and with one row in
  flight per warp instead of three; ``sweep2``, ``sweep2_select``,
  ``sweep2_waves1``, ``sweep2_waves4`` and ``sweep2_shallow``: design 2,
  the second sweep (one column a lane at every k, the chunks filling the
  resident block slots twice over), and the same with BIG and a select
  per pass-2 tap instead of +inf, with the slots filled once or four times
  over, and with rows one stage ahead at every k; ``one_column``,
  ``four_columns``, ``two_columns``, ``waves2_small``, ``waves2`` and
  ``clocks``: design 3, the port's, with one column a lane at every k, with
  four where k <= 16, with two up to k = 200 (at the fine and 1 km worlds
  too), with the resident block slots filled twice over where k <= 32 or
  at every k, and counting each warp's cycles by part of a stage (printed
  as shares after the size's timings);
* B2 and B3 at wide radii: ``l1``, ``tools/designs/
  pass2_min_unstaged_l1.cu``, and ``ring``, ``tools/designs/
  min_haversine_ring.cu``, the builds before the wide-radius redesign
  (B2's unstaged build reading
  every tap through L1; B3's large build sweeping chunks with a ring of
  pass-1 rows in device scratch); B2 with the options of the port's
  pass-2 routine, ``tools/designs/pass2_pruned_variants.cu``
  (:data:`PRUNED_OPTIONS`): ``pruned_all`` (the port's constants),
  ``noshfl`` (each tap loads its table entries instead of taking them by
  shuffle from a lane that loaded 32 steps' entries at once), ``cols1``
  and ``cols4`` (one or four columns a lane), ``warps2`` and ``warps8``
  (blocks of 2 or 8 warps), ``group4`` and ``group16`` (a vote every 4 or
  16 steps of j), ``every_tap`` (no early exit) and ``clocks`` (each
  warp's time and taps counted, printed after the size's timings); B3
  ``pruned_all``: a copy of the port's ``min_haversine.cu`` with its
  large build at every k (its ``LARGE_FROM`` set to 0, written under
  ``build/designs``); both ``pruned_all`` timed beside the
  staged builds at the 1 km and 0.5 km worlds;
* B2's two-extremum form (``B2two``): ``two_first``, ``tools/designs/
  pass2_min_two_first.cu``, its builds before the redesign (both strips
  staged to k = 93, both extrema read a tap, every tap past it);
  ``two_pruned``, a copy of this tree's ``pass2_min.cu`` whose
  two-extremum form takes the pruned build with its exit at every k,
  written under ``build/designs``, which with this tree's route (the
  staged build wherever its shared memory holds the strips, k <= 93) finds
  the crossover between the two; ``two_staged_mmin``, ``tools/designs/
  pass2_min_two_staged_mmin.cu``, a staged build that lost (Mmin alone in
  a tile whose po are all >= 0), timed where it runs (k <= 93);
* B6 ``occupancy4`` and ``unroll2``: ``tools/designs/
  halo_exchange_rows_variants.cu``, the port's design held to 64 registers
  (four blocks per SM against two), and with two 16-byte units per lane in
  flight instead of four;
* B6 ``gather`` and ``gather_rows8``: ``tools/designs/
  halo_exchange_gather.cu``, the first design (one thread per destination
  float), and the same with eight rows per thread (an eighth of the
  blocks, still one load in flight per thread).

Then holds every build bit-equal to the plain version and times it with
``chip_smoke.device_ms`` in the order of the list and then reversed: with
the L2 flushed by a write before each call (the smoke's timing), flushed by
a read (no dirty lines to write back), and warm (the inputs left in L2 by
the call before).  B1, B2, B4 and B5 on the inputs of ``chip_smoke.py``'s
kernel phases at global 0.25 and 0.1 degrees; B1 also at 0.1 degree padded
to NN = 40, 44, 48, 52 and 57 (the second small build against the large
one, which sets where the large build starts), on
``chip_smoke.fine_world`` at the coupled step's NN = 97 and ``diag``'s NN
= 208 (B4 at 97), and on
``chip_smoke.km_world`` at ``diag``'s NN = 243 (no build of the parent
takes it) and on the 0.4 km world (``wide387``) at its NN = 391; B1, B4
and B5 past NN = 2047 on ``chip_smoke.py``'s 64 x 128 land field at NN =
2048 and 2204 (``land@2048``, ``land@2204``: no window holds both
classes, so every cell runs to NN), B1 on its 1 km strip
(``chip_smoke.strip_world``, 32 x 2200 at maxdist 3000 km, NN = 2204,
``strip@2204``) and on a 600 x 128 land field at NN = 2048
(``many@2048``: 152 coastal tiles, more than the card's SMs); B6 on
random 2 x 4 shards of both grids at the width of theta's
exchange (NN), beside two yardsticks in the same passes: ``take``, the
smoke's library call (``torch.take`` through an index map), and ``copy``, a
``Tensor.copy_`` of as many bytes as the exchange writes.  Last, the host
time of B6's wrapper and of its parts.  Prints ``ptxas`` lines, one line
per build and size and a JSON line ``{"designs": ...}`` of the device times
in microseconds (flushed by a write, mean of the two passes; the others
under ``read`` and ``warm``).  B3 on the coast of ``bench.make_world`` at
0.25 and 0.1 degrees beside the hybrid distance (torch pass 1 + B2, the
yardstick ``hybrid``), and on ``chip_smoke.fine_world`` (k = 93) and
``chip_smoke.km_world`` (k = 155), where neither the parent's build nor
``first`` runs.  B2 and B3 also on 1024 x 1024 worlds from
54 N at 0.0045 degrees (``half``, k = 310), 0.0036 (``wide387``, the 0.4
km world) and 0.00225 (``wide620``), and B2 at ``km``; there the pass-2
routine takes the rows' flags of ``device_tables``.  B2's two-extremum
form on ``chip_smoke.two_extremum_inputs`` (pass 1's extrema of the main
world's coast) at k = 6, 15, 31, 62, 93, 155 and 387 and at 0.1 degrees
(k = 15), each with po drawn from [-1, 1] (``random@k``) and with the
grid's own po (``grid@k``), where the single form (this tree's, with the
rows' flags) is timed beside it as the yardstick ``single``.  ``--builds`` keeps
only the named builds (the parent's and this tree's are always kept).
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
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


#: Builds of the wide-radius pass 2's options (tools/designs/
#: pass2_pruned_variants.cu, kernel B2 with the routine at every k):
#: ``pruned_all`` the port's constants; the others each change one: no
#: shuffles (each tap loads its table entries), one or four columns a
#: lane instead of two, blocks of 2 or 8 warps instead of 4, a vote every
#: 4 or 16 steps of j instead of 8, no early exit, and counters of the
#: warps' time and taps.
PRUNED_OPTIONS = {"pruned_all": (),
                  "noshfl": ("-DSBZ_PRUNED_SHFL=0",),
                  "cols1": ("-DSBZ_PRUNED_CPL=1",),
                  "cols4": ("-DSBZ_PRUNED_CPL=4",),
                  "warps2": ("-DSBZ_PRUNED_WARPS=2",),
                  "warps8": ("-DSBZ_PRUNED_WARPS=8",),
                  "group4": ("-DSBZ_PRUNED_GROUP=4",),
                  "group16": ("-DSBZ_PRUNED_GROUP=16",),
                  "every_tap": ("-DSBZ_PRUNED_EXIT=0",),
                  "clocks": ("-DSBZ_PRUNED_CLOCKS=1",)}


def builds(against):
    """{kernel: {name: (source, extra flags)}}."""
    b2 = {"this": (CSRC / "pass2_min.cu", ())}
    b1 = {"this": (CSRC / "ring_trigger.cu", ())}
    b3 = {"this": (CSRC / "min_haversine.cu", ())}
    b6 = {"this": (CSRC / "halo_exchange.cu", ())}
    for name, root in against.items():
        src = Path(root) / "seabreeze_param_tpu_torch" / "csrc"
        b2[name] = (src / "pass2_min.cu", ())
        b3[name] = (src / "min_haversine.cu", ())
        b1[name] = (src / "ring_trigger.cu", ())
        b6[name] = (src / "halo_exchange.cu", ())
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
    b1["large"] = (CSRC / "ring_trigger.cu", ("-DSBZ_RING_LARGE_FROM=1",))
    b1["sweep"] = (CSRC / "ring_trigger.cu", ("-DSBZ_RING_SWEEP_FROM=52",))
    b1["sweep_first"] = (DESIGNS / "ring_trigger_sweep_first.cu", ())
    lv = DESIGNS / "ring_trigger_large_variants.cu"
    chains = "-DSBZ_RING_LAND_CHAINS=1"
    b1["no_vc_stage"] = (lv, ("-DSBZ_RING_VC_STAGE=0",))
    b1["no_corners"] = (lv, ("-DSBZ_RING_VC_STAGE=0", "-DSBZ_RING_CORNERS=0"))
    b1["land_chains"] = (lv, (chains,))
    b1["first"] = (lv, (chains, "-DSBZ_RING_STAGE=0",
                        "-DSBZ_RING_LARGE_BLOCKS=2"))
    b1["staged_2block"] = (lv, (chains, "-DSBZ_RING_LARGE_BLOCKS=2"))
    b1["unstaged"] = (lv, (chains, "-DSBZ_RING_STAGE=0"))
    b1["image_2block"] = (lv, ("-DSBZ_RING_LARGE_BLOCKS=2",))
    mh = DESIGNS / "min_haversine_variants.cu"
    b3["first"] = (mh, ("-DSBZ_MH_DESIGN=0",))
    one = "-DSBZ_MH_DESIGN=1"
    b3["sweep1"] = (mh, (one,))
    b3["sweep1_taps"] = (mh, (one, "-DSBZ_MH_BITS=0"))
    b3["sweep1_no_early"] = (mh, (one, "-DSBZ_MH_EARLY=0"))
    b3["sweep1_waves1"] = (mh, (one, "-DSBZ_MH_WAVES=1"))
    b3["sweep1_waves4"] = (mh, (one, "-DSBZ_MH_WAVES=4"))
    b3["sweep1_nbuf2"] = (mh, (one, "-DSBZ_MH_NBUF=2"))
    two = "-DSBZ_MH_DESIGN=2"
    b3["sweep2"] = (mh, (two,))
    b3["sweep2_select"] = (mh, (two, "-DSBZ_MH2_SELECT=1"))
    b3["sweep2_waves1"] = (mh, (two, "-DSBZ_MH2_WAVES=1"))
    b3["sweep2_waves4"] = (mh, (two, "-DSBZ_MH2_WAVES=4"))
    b3["sweep2_shallow"] = (mh, (two, "-DSBZ_MH2_DEEP_UP_TO=-1"))
    b3["one_column"] = (mh, ("-DSBZ_MH3_CPL2_UP_TO=-1",))
    b3["four_columns"] = (mh, ("-DSBZ_MH3_CPL4_UP_TO=16",))
    b3["two_columns"] = (mh, ("-DSBZ_MH3_CPL2_UP_TO=200",))
    b3["waves2_small"] = (mh, ("-DSBZ_MH3_WAVES2_UP_TO=32",))
    b3["waves2"] = (mh, ("-DSBZ_MH3_WAVES2_UP_TO=100000",))
    b3["clocks"] = (mh, ("-DSBZ_MH3_CLOCKS=1",))
    b2["l1"] = (DESIGNS / "pass2_min_unstaged_l1.cu", ())
    b3["ring"] = (DESIGNS / "min_haversine_ring.cu", ())
    for name, flags in PRUNED_OPTIONS.items():
        b2[name] = (DESIGNS / "pass2_pruned_variants.cu", flags)
    b3["pruned_all"] = (large_everywhere(), ("-I", str(CSRC)))
    b2two = {"this": (CSRC / "pass2_min.cu", ()),
             "two_first": (DESIGNS / "pass2_min_two_first.cu", ())}
    for name, root in against.items():
        b2two[name] = (Path(root) / "seabreeze_param_tpu_torch" / "csrc" /
                       "pass2_min.cu", ())
    b2two["two_pruned"] = (pruned_everywhere(), ("-I", str(CSRC)))
    b2two["two_staged_mmin"] = (DESIGNS / "pass2_min_two_staged_mmin.cu", ())
    rows = DESIGNS / "halo_exchange_rows_variants.cu"
    b6["occupancy4"] = (rows, ("-DSBZ_HALO_MIN_BLOCKS=4",))
    b6["unroll2"] = (rows, ("-DSBZ_HALO_UNROLL=2",))
    gather = DESIGNS / "halo_exchange_gather.cu"
    b6["gather"] = (gather, ())
    b6["gather_rows8"] = (gather, ("-DSBZ_HALO_ROWS=8",))
    return {"B2": b2, "B1": b1, "B3": b3, "B6": b6, "B2two": b2two}


def pruned_everywhere():
    """A copy of this tree's ``csrc/pass2_min.cu`` whose two-extremum form
    takes its pruned build at every k (its tests of ``k > MAX_STAGED_K2``,
    in the launcher and its scratch, made true), written under
    :data:`OUT`."""
    test = "k > MAX_STAGED_K2"
    src = (CSRC / "pass2_min.cu").read_text()
    if src.count(test) != 2:
        raise RuntimeError(f"pass2_min.cu no longer routes by {test!r} "
                           "in two places")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "pass2_min_two_pruned_everywhere.cu"
    path.write_text(src.replace(test, "k >= 0"))
    return path


def large_everywhere():
    """A copy of this tree's ``csrc/min_haversine.cu`` whose large build
    takes every k (``LARGE_FROM`` 0), written under :data:`OUT`."""
    line = "constexpr int LARGE_FROM = MAX_K + 1;"
    src = (CSRC / "min_haversine.cu").read_text()
    if line not in src:
        raise RuntimeError(f"min_haversine.cu no longer holds {line!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "min_haversine_large_everywhere.cu"
    path.write_text(src.replace(line, "constexpr int LARGE_FROM = 0;"))
    return path


#: B3's large launcher in a source where it takes the rows' flags (this
#: tree's) instead of the columns' (PR 9's, ``tools/designs/
#: min_haversine_ring.cu``).
LARGE_TAKES_ROWS = re.compile(
    r'extern "C" int sbz_min_haversine_large\([^)]*\brow_mono\b')


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
        lib.large_takes_rows = bool(LARGE_TAKES_ROWS.search(
            Path(table[key[0]][key[1]][0]).read_text()))
        for fn, args in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                # B2's launcher from before its row flags (B3's large one
                # took the columns' flags where it now takes the rows')
                if fn == "sbz_pass2_min" and not hasattr(
                        lib, "sbz_pass2_min_layout"):
                    args = args[:3] + args[4:]
                # the two-extremum launcher from before its scratch
                if fn == "sbz_pass2_min_two" and not hasattr(
                        lib, "sbz_pass2_min_two_scratch"):
                    args = args[:-2] + args[-1:]

                # ring launchers from before their scratch argument, B3's
                # from before its monotone flags
                if fn in RING_LAUNCHERS and not hasattr(lib,
                                                        "sbz_ring_scratch"):
                    args = args[:-2] + args[-1:]
                if fn == "sbz_min_haversine":
                    if hasattr(lib, "sbz_min_haversine_row_flags"):
                        args = args[:4] + (ctypes.c_void_p,) + args[4:]
                    elif not hasattr(lib, "sbz_min_haversine_limits"):
                        args = args[:4] + args[5:]
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


RING_LAUNCHERS = ("sbz_ring_trigger_stacked", "sbz_ring_trigger_padded",
                  "sbz_ring_thc_padded")


def ring_scratch(lib, h, w, nn, device):
    """``(args, buf)``: the scratch argument of ``lib``'s ring launchers at
    radius ``nn`` over an (h, w) field, as a tuple to splice in before the
    stream (empty for a library from before that argument, else the
    pointer to as many int32 as the library asks for, None where it asks
    for none), and the tensor behind it, which the caller keeps."""
    import torch
    if not hasattr(lib, "sbz_ring_scratch"):
        return (), None
    ints = ctypes.c_longlong()
    lib.sbz_ring_scratch(h, w, nn, ctypes.byref(ints))
    if ints.value == 0:
        return (None,), None
    buf = torch.empty(ints.value, dtype=torch.int32, device=device)
    return (buf.data_ptr(),), buf


def stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


#: The regional worlds of the distance kernels: name -> (spacing in degrees,
#: top latitude, steps); k at 180 km: 93, 155, 310, 387, 620.
REGIONAL = {"fine": (cs.FINE_SPACING, 55.0, cs.FINE_STEPS),
            "km": (cs.KM_SPACING, 54.0, cs.KM_STEPS),
            "half": (0.0045, 54.0, 1),
            "wide387": (0.0036, 54.0, cs.WIDE_STEPS),
            "wide620": (0.00225, 54.0, cs.WIDE_STEPS)}


def distance_world(name):
    """(grid, lsm, first step's sea ice) of ``bench.GRIDS[name]`` or of a
    :data:`REGIONAL` world (the smoke's own where it has one)."""
    from bench import GRIDS, make_world
    if name == "fine":
        grid, world = cs.fine_world()
    elif name == "km":
        grid, world = cs.km_world()
    elif name in ("wide387", "wide620"):
        grid, world = cs.wide_world(REGIONAL[name][0])
    elif name in REGIONAL:
        grid, world = cs.regional_world(*REGIONAL[name])
    else:
        grid, _, _ = cs.world_grid(name)
        world = make_world(*GRIDS[name], 1, 1, seed=3)
    return grid, world[0], world[7][0]


def b2_inputs(name):
    import torch
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, effective_radius, pad_coast, pass1_extrema)
    grid, lsm, ci = distance_world(name)
    dev = torch.device("cuda")
    k = effective_radius(grid, 180.0)
    tabs = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci, device=dev))
    mmin, _ = pass1_extrema(pad_coast(coast, k), tabs[2], k)
    return mmin, tabs[0], tabs[1], tabs.row_monotone, k


def b2_case(name):
    """(check, make_call) for B2 at ``name``."""
    import torch
    from seabreeze_param_tpu_torch.ops.distance import pass2_min
    Mmin, sdphi2, po, rows, k = b2_inputs(name)
    h, w = Mmin.shape[0] - 2 * k, Mmin.shape[1]
    ref = pass2_min(Mmin, sdphi2, po, k)
    out = torch.empty((h, w), device=Mmin.device)

    def make_call(lib):
        flags = ((rows.data_ptr(),) if hasattr(lib, "sbz_pass2_min_layout")
                 else ())

        def call():
            err = lib.sbz_pass2_min(Mmin.data_ptr(), sdphi2.data_ptr(),
                                    po.data_ptr(), *flags, out.data_ptr(), h,
                                    w, k, stream())
            assert err == 0, f"sbz_pass2_min: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return bool(torch.equal(out, ref))
    return check, make_call


#: B2's two-extremum form: (world, k) of each timed size, the main world's
#: coast at the radii where its builds cross over, and 0.1 deg's own k.
TWO_SIZES = [("global025", k) for k in (6, 15, 31, 62, 93, 155, 387)] + [
    ("global010", 15)]


@functools.cache
def two_world(name):
    """(grid, lsm, first step's sea ice) of the smoke's main world or of
    0.1 deg's ``bench.make_world`` field."""
    from bench import make_world
    if name == "global025":
        grid, (lsm, *_, ci) = cs.main_world()
    else:
        grid = cs.world_grid(name)[0]
        lsm, *_, ci = make_world(grid.nlat, grid.nlon, 1, 1, seed=3)
    return grid, lsm, ci[0]


def b2two_case(name, k, kind):
    """(check, make_call, yardsticks) for B2's two-extremum form on world
    ``name`` at radius ``k`` with po of ``kind`` (``random`` or ``grid``);
    with the grid's po the yardstick ``single``, this tree's single form
    (its rows' flags) on the same Mmin."""
    import torch
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.distance import pass2_min
    dev = torch.device("cuda")
    mmin, mmax, sdphi2, pos, rows = cs.two_extremum_inputs(
        *two_world(name), k, dev)
    po = pos[kind]
    h, w = mmin.shape[0] - 2 * k, mmin.shape[1]
    ref = pass2_min(mmin, sdphi2, po, k, Mmax=mmax)
    out = torch.empty((h, w), device=dev)

    def make_call(lib):
        # this tree's launcher takes its scratch (the parent's none)
        scratch, buf = (), None
        if hasattr(lib, "sbz_pass2_min_two_scratch"):
            floats = ctypes.c_longlong(0)
            lib.sbz_pass2_min_two_scratch(h, w, k, ctypes.byref(floats))
            if floats.value:
                buf = torch.empty(floats.value, device=dev)
            scratch = (None if buf is None else buf.data_ptr(),)

        def call(buf=buf):
            err = lib.sbz_pass2_min_two(
                mmin.data_ptr(), mmax.data_ptr(), sdphi2.data_ptr(),
                po.data_ptr(), out.data_ptr(), h, w, k, *scratch, stream())
            assert err == 0, f"sbz_pass2_min_two: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return bool(torch.equal(out.view(torch.int32),
                                ref.view(torch.int32)))

    yard = None if kind != "grid" else {
        "single": lambda: pass2_min_cuda(mmin, sdphi2, po, k,
                                         row_monotone=rows)}
    return check, make_call, yard


def b3_case(name):
    """(check, make_call, yardsticks) for B3 at ``name``: one of
    ``bench.GRIDS`` or :data:`REGIONAL`; the yardstick ``hybrid`` (torch
    pass 1 + this build's B2) at the global grids only (at the regional
    ones its ~190-1240 pass-1 launches per call outrun the card's queue,
    which ``device_ms`` needs ahead of the device)."""
    import torch
    from seabreeze_param_tpu_torch.ops.coastline import get_edges
    from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
        pass2_min_cuda)
    from seabreeze_param_tpu_torch.ops.distance import (
        device_tables, effective_radius, min_haversine_param_from_padded,
        pad_coast, pass1_extrema)
    grid, lsm, ci = distance_world(name)
    dev = torch.device("cuda")
    k = effective_radius(grid, 180.0)
    tabs = device_tables(grid, k, dev)
    cpad = pad_coast(get_edges(torch.as_tensor(lsm, device=dev),
                               torch.as_tensor(ci, device=dev)), k)
    h, w = grid.shape
    ref = min_haversine_param_from_padded(cpad, *tabs, k)
    out = torch.empty((h, w), device=dev)

    def make_call(lib):
        flags = ((tabs.monotone.data_ptr(),)
                 if hasattr(lib, "sbz_min_haversine_limits") else ())
        # the first sweep's interface also takes the rows' flags
        if hasattr(lib, "sbz_min_haversine_row_flags"):
            flags = (tabs.row_monotone.data_ptr(),) + flags
        floats = ctypes.c_longlong(0)
        if hasattr(lib, "sbz_min_haversine_scratch"):
            lib.sbz_min_haversine_scratch(h, w, k, ctypes.byref(floats))
        if floats.value:
            # the large build (this tree's with the rows' flags instead of
            # the columns'), its scratch kept with the call
            if lib.large_takes_rows:
                flags = (tabs.row_monotone.data_ptr(),)
            scratch = torch.empty(floats.value, device=dev)

            def call():
                err = lib.sbz_min_haversine_large(
                    cpad.data_ptr(), *(t.data_ptr() for t in tabs), *flags,
                    out.data_ptr(), h, w, k, scratch.data_ptr(), stream())
                assert err == 0, f"sbz_min_haversine_large: cudaError_t {err}"
            return call

        def call():
            err = lib.sbz_min_haversine(
                cpad.data_ptr(), *(t.data_ptr() for t in tabs), *flags,
                out.data_ptr(), h, w, k, stream())
            assert err == 0, f"sbz_min_haversine: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return bool(torch.equal(out, ref))

    yard = None if name in REGIONAL else {
        "hybrid": lambda: pass2_min_cuda(pass1_extrema(cpad, tabs[2], k)[0],
                                         tabs[0], tabs[1], k)}
    return check, make_call, yard


#: A land field past NN = 2047 with more coastal tiles (152 of 16 x 32)
#: than an H100 has SMs (132): test_torch_cuda.py's many-tiles field.
MANY_FIELD = (600, 128)


def land_inputs(nn, shape=None):
    """``chip_smoke.phase_past_2047``'s field past NN = 2047: ``shape``
    (default PAST_FIELD) cells, all land within maxdist (no window holds
    both classes), padded at ``nn``, made from the seed ``nn``; in
    :func:`ring_inputs`' form."""
    import torch
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.ops.trigger import cadence
    h, w = cs.PAST_FIELD if shape is None else shape
    rng = np.random.default_rng(nn)
    D = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    cd_pad = D((50.0 + 100.0 * rng.random((h + 2 * nn, w + 2 * nn)))
               .astype(np.float32))
    t0_pad = D((280.0 + 10.0 * rng.random(cd_pad.shape)).astype(np.float32))
    ws_new, wd_new, ws0, wd0 = (D(a) for a in (
        (5 + 3 * rng.random((h, w))).astype(np.float32),
        (360 * rng.random((h, w)) - 180).astype(np.float32),
        (5 + rng.random((h, w))).astype(np.float32),
        (360 * rng.random((h, w)) - 180).astype(np.float32)))
    params = Params()
    return dict(nlat=h, nlon=w, nn=nn, params=params,
                cd=cd_pad[nn:nn + h, nn:nn + w].contiguous(), ws_new=ws_new,
                wd_new=wd_new, t0_pad=t0_pad, cd_pad=cd_pad, ws0=ws0, wd0=wd0,
                flags=cadence(15, params))


def ring_inputs(name, nn=None):
    """One step of a world (tt = 15, a wind refresh) on the card: the ring
    kernels' inputs padded at ``nn`` (default: the pipeline's NN) and the
    state.  ``name``: one of ``bench.GRIDS``, ``fine`` for
    ``chip_smoke.fine_world``, ``km`` for ``chip_smoke.km_world``,
    ``wide387`` for the 0.4 km world of ``chip_smoke.wide_world``, ``strip``
    for ``chip_smoke.strip_world`` (maxdist STRIP_MAXDIST), ``land`` for
    :func:`land_inputs` or ``many`` for it on :data:`MANY_FIELD`."""
    import torch
    from bench import GRIDS, make_world
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.trigger import cadence, prepare_step
    if name == "land":
        return land_inputs(nn)
    if name == "many":
        return land_inputs(nn, MANY_FIELD)
    params = Params()
    if name == "strip":
        params = Params(maxdist=cs.STRIP_MAXDIST)
        grid, world = cs.strip_world()
        nlat, nlon = grid.shape
    elif name in ("fine", "km", "wide387"):
        grid, world = (cs.fine_world() if name == "fine" else cs.km_world()
                       if name == "km" else cs.wide_world(REGIONAL[name][0]))
        nlat, nlon = grid.shape
    else:
        grid, _, _ = cs.world_grid(name)
        nlat, nlon = GRIDS[name]
        world = make_world(nlat, nlon, 4, 3, seed=3)
    lsm, z, std, pres, theta, u, v, ci = world
    dev = torch.device("cuda")
    pipe = TriggerPipeline(grid, params=params, device=dev)
    nn = pipe.nn_max if nn is None else nn
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    t = min(2, len(theta) - 1)              # the 0.4 km world has 2 steps
    cd = pipe.distance_field(D(lsm), D(ci[t]))
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[t]), D(u[t]), D(v[t]), cd, D(z), D(std), D(pres), params, nn)
    ws0 = torch.full((nlat, nlon), 5.0, device=dev)
    wd0 = torch.full((nlat, nlon), 90.0, device=dev)
    return dict(nlat=nlat, nlon=nlon, nn=nn, params=params, cd=cd,
                ws_new=ws_new, wd_new=wd_new, t0_pad=t0_pad, cd_pad=cd_pad,
                ws0=ws0, wd0=wd0, flags=cadence(15, params))


def _scalars(params):
    f32 = np.float32
    return tuple(float(f32(x)) for x in (
        params.maxdist, params.thresh_wind, params.thresh_winddir,
        params.thresh_windch, params.thresh_thc))


def b1_case(name, nn=None):
    """(check, make_call) for B1 at ``name`` (padded at ``nn``): every tile
    holding a coastal cell in the ever-coastal set at the build's tile."""
    import torch
    from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import StackedScan
    from seabreeze_param_tpu_torch.ops.trigger import trigger_cells
    x = ring_inputs(name, nn)
    nlat, nlon, nn, params, cd = (x[k] for k in ("nlat", "nlon", "nn",
                                                 "params", "cd"))
    ws0, wd0 = x["ws0"], x["wd0"]
    is_first, upd = x["flags"]
    ref = trigger_cells(cd, x["ws_new"], x["wd_new"], ws0, wd0, x["t0_pad"],
                        x["cd_pad"], is_first, upd, params, nn)
    bufs = [torch.empty((1, nlat, nlon), device=cd.device) for _ in range(3)]
    state = [ws0.clone(), wd0.clone()]

    def tile_of(lib):
        if not hasattr(lib, "sbz_ring_tile"):
            return (16, 32)
        th, tw = ctypes.c_int(), ctypes.c_int()
        lib.sbz_ring_tile(ctypes.byref(th), ctypes.byref(tw))
        return th.value, tw.value

    def make_call(lib):
        ever = cs.tile_mask(cd, params.maxdist, tile_of(lib))
        scratch, buf = ring_scratch(lib, nlat, nlon, nn, cd.device)

        def call(buf=buf):
            err = lib.sbz_ring_trigger_stacked(
                x["t0_pad"].data_ptr(), x["cd_pad"].data_ptr(), cd.data_ptr(),
                x["ws_new"].data_ptr(), x["wd_new"].data_ptr(),
                state[0].data_ptr(), state[1].data_ptr(), ever.data_ptr(),
                bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
                nlat, nlon, nn, 0, int(is_first), int(upd), 0, nlat,
                int(params.skip_last_lat_row), *_scalars(params), *scratch,
                stream())
            assert err == 0, f"sbz_ring_trigger_stacked: cudaError_t {err}"
        return call

    def check(lib):
        # the stacks pre-filled: what a tile never visited keeps
        pre = StackedScan(nlat, nlon, params, cd.device).init_buffers(1, ws0,
                                                                      wd0)
        for b, p in zip(bufs, pre):
            b.copy_(p)
        state[0].copy_(ws0)
        state[1].copy_(wd0)
        make_call(lib)()
        return all(torch.equal(b[0], r) for b, r in zip(bufs, ref[:3])) and (
            torch.equal(state[0], ref[3]) and torch.equal(state[1], ref[4]))
    return check, make_call


def b4_case(name, nn=None):
    """(check, make_call) for B4 (every tile, one step) at ``name``
    (padded at ``nn``)."""
    import torch
    from seabreeze_param_tpu_torch.ops.trigger import trigger_cells
    x = ring_inputs(name, nn)
    nlat, nlon, nn, params, cd = (x[k] for k in ("nlat", "nlon", "nn",
                                                 "params", "cd"))
    is_first, upd = x["flags"]
    ins = [x[k] for k in ("t0_pad", "cd_pad")] + [cd] + [
        x[k] for k in ("ws_new", "wd_new", "ws0", "wd0")]
    ref = trigger_cells(cd, x["ws_new"], x["wd_new"], x["ws0"], x["wd0"],
                        x["t0_pad"], x["cd_pad"], is_first, upd, params, nn)
    outs = [torch.empty((nlat, nlon), device=cd.device) for _ in range(3)]

    def make_call(lib):
        scratch, buf = ring_scratch(lib, nlat, nlon, nn, cd.device)

        def call(buf=buf):
            err = lib.sbz_ring_trigger_padded(
                *(t.data_ptr() for t in ins + outs), nlat, nlon, nn,
                int(is_first), int(upd), 0, nlat,
                int(params.skip_last_lat_row), *_scalars(params), *scratch,
                stream())
            assert err == 0, f"sbz_ring_trigger_padded: cudaError_t {err}"
        return call

    def check(lib):
        for o in outs:
            o.fill_(float("nan"))
        make_call(lib)()
        return all(torch.equal(o, r) for o, r in zip(outs, (ref[0], ref[3],
                                                            ref[4])))
    return check, make_call


def b5_case(name, nn=None):
    """(check, make_call) for B5 (the ring search alone) at ``name``
    (padded at ``nn``)."""
    import torch
    from seabreeze_param_tpu_torch.ops.ring_search import (
        ring_quantities, ring_thc_from_padded)
    x = ring_inputs(name, nn)
    nlat, nlon, nn, params, cd = (x[k] for k in ("nlat", "nlon", "nn",
                                                 "params", "cd"))
    maxdist = float(np.float32(params.maxdist))
    ref = ring_thc_from_padded(ring_quantities(x["t0_pad"], x["cd_pad"]),
                               torch.where(cd >= 0, 1.0, -1.0), nn,
                               coastal=cd.abs() <= maxdist)[0]
    out = torch.empty((nlat, nlon), device=cd.device)

    def make_call(lib):
        scratch, buf = ring_scratch(lib, nlat, nlon, nn, cd.device)

        def call(buf=buf):
            err = lib.sbz_ring_thc_padded(
                x["t0_pad"].data_ptr(), x["cd_pad"].data_ptr(), cd.data_ptr(),
                out.data_ptr(), nlat, nlon, nn, maxdist, *scratch, stream())
            assert err == 0, f"sbz_ring_thc_padded: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return bool(torch.equal(out, ref))
    return check, make_call


def b6_inputs(name):
    """Random 2 x 4 shards of grid ``name`` (as ``chip_smoke.phase_halo``)
    and the width of theta's exchange, NN."""
    import torch
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    grid, _, _ = cs.world_grid(name)
    dev = torch.device("cuda")
    mesh, (h, w) = cs.shard_mesh_and_shape(name)
    gen = torch.Generator(device=dev).manual_seed(4)
    local = [torch.randn((h, w), generator=gen, device=dev)
             for _ in range(mesh.size)]
    return mesh, local, TriggerPipeline(grid, device=dev).nn_max


def b6_case(name):
    """(check, make_call, yardsticks) for B6 at ``name``: theta's exchange
    (1 channel, NN wide, clamp fill, the quirky seam), launched through the
    C interface with the pointer arrays made once; the yardsticks are
    ``take`` and ``copy`` (module docstring)."""
    import torch
    from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain
    mesh, local, nn = b6_inputs(name)
    kw = dict(lat_fill="clamp", exact_lon=True)
    ref = halo_exchange_plain(local, mesh, nn, nn, **kw)
    out = torch.empty((mesh.size,) + tuple(ref[0].shape), device=ref[0].device)
    ptrs = ctypes.c_void_p * mesh.size
    src = ptrs(*(x.data_ptr() for x in local))
    dst = ptrs(*(o.data_ptr() for o in out))
    h, w = local[0].shape

    def make_call(lib):
        def call():
            err = lib.sbz_halo_exchange(src, dst, mesh.py, mesh.px, 1, h, w,
                                        nn, nn, 0, 1, stream())
            assert err == 0, f"sbz_halo_exchange: cudaError_t {err}"
        return call

    def check(lib):
        out.fill_(float("nan"))
        make_call(lib)()
        return all(torch.equal(o, r) for o, r in zip(out, ref))

    take = cs.halo_take(local, mesh, nn, kw)
    assert torch.equal(take(), torch.stack(ref))
    stacked = torch.stack(local)
    flat_src = torch.empty(out.numel(), device=out.device)
    flat_src[:stacked.numel()] = stacked.reshape(-1)
    flat_dst = torch.empty_like(flat_src)
    yard = {"take": take, "copy": lambda: flat_dst.copy_(flat_src)}
    return check, make_call, yard


def b6_host_parts(reps=200):
    """Host microseconds per call of B6's wrapper and of its parts at the
    0.25-degree shards: validation, the outputs' allocation (one tensor, and
    one per shard as the wrapper did before), the pointer arrays, and the
    bare C launch."""
    import time
    import torch
    from seabreeze_param_tpu_torch.ops.cuda import _build
    from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import (
        halo_exchange_cuda)
    from seabreeze_param_tpu_torch.parallel.halo import check_exchange
    mesh, local, nn = b6_inputs("global025")
    h, w = local[0].shape
    shape = (h + 2 * nn, w + 2 * nn)
    lib = _build.load()
    out = [torch.empty(shape, device=local[0].device)
           for _ in range(mesh.size)]
    ptrs = ctypes.c_void_p * mesh.size
    src = ptrs(*(x.data_ptr() for x in local))
    dst = ptrs(*(o.data_ptr() for o in out))
    s = stream()

    def validate():
        check_exchange(local, mesh, nn, nn, "clamp")
        for i, x in enumerate(local):
            _build.require(x, f"shard {i}", (h, w), x.device)

    def device_guard():
        with torch.cuda.device(local[0].device):
            pass

    parts = {
        "wrapper": lambda: halo_exchange_cuda(local, mesh, nn, nn),
        "validate": validate,
        "alloc_one": lambda: torch.empty((mesh.size,) + shape,
                                         device=local[0].device).unbind(0),
        "alloc_per_shard": lambda: [torch.empty(shape, device=local[0].device)
                                    for _ in range(mesh.size)],
        "pointer_arrays": lambda: (ptrs(*(x.data_ptr() for x in local)),
                                   ptrs(*(o.data_ptr() for o in out))),
        "device_guard": device_guard,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "c_launch": lambda: lib.sbz_halo_exchange(src, dst, mesh.py, mesh.px,
                                                  1, h, w, nn, nn, 0, 1, s),
    }
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        res[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return res


def b3_clocks(lib, call):
    """One call of a B3 build counting cycles by part
    (``SBZ_MH2_CLOCKS``): each part's share of the warps' cycles, the
    mean and most cycles of a block, and the blocks."""
    import torch
    buf = (ctypes.c_ulonglong * 7)()
    lib.sbz_min_haversine_clocks(buf)            # zero the counters
    call()
    torch.cuda.synchronize()
    lib.sbz_min_haversine_clocks(buf)
    parts = ("wait", "pass1", "pass2", "barrier")
    total = sum(buf[:4]) or 1
    res = {p: buf[i] / total for i, p in enumerate(parts)}
    res.update(block_mean=buf[4] / max(buf[6], 1), block_max=float(buf[5]),
               blocks=float(buf[6]))
    return res


def pass2_clocks(lib, call):
    """One call of B2's unstaged build counting its warps
    (``SBZ_PRUNED_CLOCKS``): the call's span from the first warp's start to
    the last warp's end, the warps' mean time and taps, the time a tap
    takes a warp, and how many warps ran at once on average (their summed
    time over the span)."""
    import torch
    buf = (ctypes.c_ulonglong * 5)()
    lib.sbz_pass2_min_clocks(buf)                # zero the counters
    call()
    torch.cuda.synchronize()
    lib.sbz_pass2_min_clocks(buf)
    ns, taps, warps = buf[0], buf[1], max(buf[2], 1)
    span = max(buf[4] - buf[3], 1)
    return dict(span_us=span / 1e3, warp_us=ns / warps / 1e3,
                taps_per_warp=taps / warps, ns_per_tap=ns / max(taps, 1),
                warps_at_once=ns / span, warps=float(warps))


def time_round(names, libs_of, check, make_call, reps, yard=None):
    """Every build of ``names`` (and each yardstick) held bit-equal, then
    timed in list order and reversed, in each L2 mode; returns
    {(name, mode): [us, us]}."""
    names = list(names) + list(yard or {})
    times = {(n, m): [] for n in names for m in MODES}
    for name in names + names[::-1]:
        if yard and name in yard:
            call = yard[name]
        else:
            lib = libs_of(name)
            if not check(lib):
                raise AssertionError(f"{name}: not bit-equal to the plain "
                                     "version")
            call = make_call(lib)
        for m, flush in MODES.items():
            times[name, m].append(cs.device_ms(call, reps=reps, flush=flush)
                                  * 1e3)
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose csrc/ is also built")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--only", default="B1,B2,B3,B4,B5,B6,B2two",
                    help="comma-separated kernels to time")
    ap.add_argument("--builds", default=None,
                    help="comma-separated builds to keep (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    only = set(args.only.split(","))
    against = dict(a.split("=", 1) for a in args.against)
    table = builds(against)
    need = {"B1": "B1", "B4": "B1", "B5": "B1", "B2": "B2", "B3": "B3",
            "B6": "B6", "B2two": "B2two"}
    table = {k: v for k, v in table.items()
             if any(need[o] == k for o in only)}
    if args.builds:
        keep = {"this", *against, *args.builds.split(",")}
        table = {k: {n: b for n, b in v.items() if n in keep}
                 for k, v in table.items()}
    libs = build_all(table)
    # the timing's floor: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    floor = {m: cs.device_ms(lambda: one.add_(1.0), reps=args.reps,
                             flush=f) * 1e3 for m, f in MODES.items()}
    print(f"# timing floor (a one-element kernel): L2 flushed by a write "
          f"{floor['write']:.2f} us, by a read {floor['read']:.2f}, warm "
          f"{floor['warm']:.2f}", flush=True)
    result = {"floor": floor}
    mine = ["this", *against]
    ring = mine + ["large"]
    pr5 = ["variants", "prefetch", "tall", "tall_prefetch"]
    large = ["no_vc_stage", "no_corners", "land_chains", "first",
             "staged_2block", "unstaged", "image_2block"]
    # (kernel, library group, size, case, builds: None for every build of
    # the group that exports the kernel's launcher)
    plan = []
    for size in ("global025", "global010"):
        plan += [("B2", "B2", size, lambda z=size: b2_case(z), None),
                 ("B1", "B1", size, lambda z=size: b1_case(z), ring + pr5),
                 ("B4", "B1", size, lambda z=size: b4_case(z), ring),
                 ("B5", "B1", size, lambda z=size: b5_case(z), ring),
                 ("B6", "B6", size, lambda z=size: b6_case(z), None)]
    plan += [("B1", "B1", f"global010@{nn}",
              lambda nn=nn: b1_case("global010", nn),
              ["this", "large"]) for nn in (40, 44, 48, 52, 57)]
    plan += [("B1", "B1", f"fine@{nn}", lambda nn=nn: b1_case("fine", nn),
              mine + large + (["sweep"] if nn == 208 else []))
             for nn in (97, 208)]
    plan += [("B4", "B1", "fine@97", lambda: b4_case("fine", 97),
              mine + large)]
    plan += [("B1", "B1", "km@243", lambda: b1_case("km", 243),
              mine + large + ["sweep"])]
    # the 0.4 km world at diag's NN (the parent's large build takes it)
    plan += [("B1", "B1", "wide387@391", lambda: b1_case("wide387", 391),
              mine + ["sweep"])]
    # past NN = 2047: the smoke's land field and its 1 km strip
    for nn in cs.PAST_NN:
        plan += [(kern, "B1", f"land@{nn}", lambda f=f, nn=nn: f("land", nn),
                  mine + ["sweep_first"])
                 for kern, f in (("B1", b1_case), ("B4", b4_case),
                                 ("B5", b5_case))]
    plan += [("B1", "B1", "strip@2204", lambda: b1_case("strip"),
              mine + ["sweep_first"])]
    plan += [("B1", "B1", "many@2048", lambda: b1_case("many", 2048), mine)]
    # the wide-radius designs run only where their routine is taken
    wide = ("l1", "ring", *PRUNED_OPTIONS)
    plan = [(kern, group, size, case, names if names is not None else
             [n for n in table.get(group, ()) if n not in wide])
            for kern, group, size, case, names in plan]
    plan += [("B3", "B3", size, lambda z=size: b3_case(z),
              [n for n in table.get("B3", ()) if n not in wide])
             for size in ("global025", "global010")]
    # the first design refuses k >= 89
    plan += [("B3", "B3", "fine", lambda: b3_case("fine"),
              [n for n in table.get("B3", ()) if n not in ("first", *wide)])]
    # the staged builds beside the pruned routine at every k
    plan += [("B3", "B3", size, lambda z=size: b3_case(z),
              ["this", *against, "pruned_all"]) for size in ("km", "half")]
    plan += [("B2", "B2", "km", lambda: b2_case("km"),
              ["this", *against, "pruned_all"])]
    plan += [("B2", "B2", size, lambda z=size: b2_case(z),
              ["this", *against, "l1", *PRUNED_OPTIONS])
             for size in ("half", "wide387", "wide620")]
    plan += [("B3", "B3", size, lambda z=size: b3_case(z),
              ["this", *against, "ring"]) for size in ("wide387", "wide620")]
    # the two-extremum form: the staged build only where it fits
    plan += [("B2two", "B2two", f"{kind}@{k}" + ("" if world == "global025"
                                                  else f"@{world}"),
              lambda w=world, k=k, kind=kind: b2two_case(w, k, kind),
              ["this", *against, "two_first", "two_pruned"]
              + (["two_staged_mmin"] if k <= 93 else []))
             for world, k in TWO_SIZES for kind in ("random", "grid")]
    for kern, group, size, case, names in plan:
        if kern not in only:
            continue
        made = case()
        check, make_call = made[:2]
        yard = made[2] if len(made) > 2 else None
        names = [n for n in (names or table[group])
                 if n in table[group]]
        times = time_round(names, lambda n, g=group: libs[g, n], check,
                           make_call, args.reps, yard)
        mean = {k: sum(t) / len(t) for k, t in times.items()}
        for name in names + list(yard or {}):
            t = times[name, "write"]
            tag = "yardstick" if yard and name in yard else "bit-equal"
            print(f"# {kern} {size} {name:14s} {tag}; device "
                  f"{t[0]:.2f} / {t[1]:.2f} us (forward / reversed), "
                  f"L2 flushed by a read {mean[name, 'read']:.2f}, "
                  f"warm {mean[name, 'warm']:.2f}", flush=True)
        for name in names:
            lib = libs[group, name]
            if hasattr(lib, "sbz_pass2_min_clocks"):
                clk = pass2_clocks(lib, make_call(lib))
                print(f"# {kern} {size} {name:14s} warps: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in clk.items()), flush=True)
                result.setdefault("B2_clocks", {})[size] = clk
            if hasattr(lib, "sbz_min_haversine_clocks"):
                clk = b3_clocks(lib, make_call(lib))
                print(f"# {kern} {size} {name:14s} cycles by part: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in clk.items()), flush=True)
                result.setdefault("B3_clocks", {})[size] = clk
        out = result.setdefault(kern, {})
        out[size] = {n: mean[n, "write"] for n in names + list(yard or {})}
        for m in ("read", "warm"):
            out.setdefault(m, {})[size] = {
                n: mean[n, m] for n in names + list(yard or {})}
    if "B6" in only:
        host = b6_host_parts()
        print("# B6 wrapper host us per call at global025: " + ", ".join(
            f"{k} {v:.1f}" for k, v in host.items()), flush=True)
        result["B6_host_us"] = host
    print(json.dumps({"designs": result, "device": smi.splitlines()[0],
                      "unit": "us, mean of the two passes"}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
