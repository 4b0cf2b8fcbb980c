"""Wrappers of the distance-transform kernels, replacing the JAX package's
``ops/pallas/distance_kernel.py``:

* B2 :func:`pass2_min_cuda` (``csrc/pass2_min.cu``, replaces
  ``pass2_min_pallas``): pass 2 of the separable minimum; plain version
  ``ops.distance.pass2_min``; every radius (past
  :func:`pass2_min_limits` an unstaged build, one warp per row visiting
  the taps centre-out with an exact early exit, ``csrc/pass2_pruned.cuh``);
  its two-extremum form, ``pass2_min_pallas`` with ``Mmax``, is
  :func:`pass2_min_two_cuda` (one extremum a tap, chosen by the sign of
  po; staged up to :func:`pass2_min_two_limits`, then the same routine
  with an exact early exit for po of either sign);
* B3 :func:`min_haversine_param_cuda` (``csrc/min_haversine.cu``, replaces
  ``min_haversine_param_pallas``): both passes fused, each block sweeping
  a band of columns; plain version
  ``ops.distance.min_haversine_param_from_padded``; every radius (past
  :func:`min_haversine_limits` the large build: each column's monotone
  pieces, pass 1 once per padded row into device scratch, then B2's
  unstaged pass 2).

Both take the ``row_monotone`` flags of ``ops.distance.DistanceTables``:
rows of sdphi2 that do not increase from either end of the window to its
centre, where the wide-radius pass 2 may stop early.  They hold only
because ``po >= 0`` and ``Mmin >= 0`` (the tables' and pass 1's own
values); ``None`` runs every tap, with the same result.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..distance import min_haversine_param_from_padded, pass2_min
from . import _build


def _flags(t, name, n, dev):
    """The data pointer of a uint8 flag tensor of length ``n``, or None."""
    if t is None:
        return None
    _build.require(t, name, (n,), dev, torch.uint8)
    return t.data_ptr()


def _require_pass2(Mmin, sdphi2, po, k: int):
    """(h, w) of pass 2's output, after checking its inputs."""
    h, w = Mmin.shape[0] - 2 * k, Mmin.shape[1]
    _build.require(Mmin, "Mmin", (h + 2 * k, w), Mmin.device)
    _build.require(sdphi2, "sdphi2", (h, 2 * k + 1), Mmin.device)
    _build.require(po, "po", (h, 2 * k + 1), Mmin.device)
    return h, w


def pass2_min_cuda(Mmin, sdphi2, po, k: int, *, Mmax=None,
                   row_monotone=None):
    """amin (h, w) = min over the lat window of sdphi2 + po * Mmin.

    ``Mmin`` (h+2k, w), ``sdphi2``/``po`` (h, 2k+1), float32, contiguous;
    ``row_monotone``: the rows' flags of ``ops.distance.DistanceTables``
    (uint8, (h,)) or None (every tap, the same result).  A CUDA tensor
    launches the kernel on the current stream (its staged build up to
    :func:`pass2_min_limits`, the unstaged one past it, which alone uses
    the flags); a CPU tensor takes the plain version.  Each launch adds
    one to ``pass2_min_cuda.launches``.  With ``Mmax`` (pass 1's maxima,
    as Mmin) the two-extremum form, :func:`pass2_min_two_cuda`, which
    ignores ``row_monotone``.
    """
    k = int(k)
    if Mmax is not None:
        return pass2_min_two_cuda(Mmin, Mmax, sdphi2, po, k)
    if Mmin.device.type == "cpu":
        return pass2_min(Mmin, sdphi2, po, k)
    h, w = _require_pass2(Mmin, sdphi2, po, k)
    rows = _flags(row_monotone, "row_monotone", h, Mmin.device)
    out = torch.empty((h, w), dtype=torch.float32, device=Mmin.device)
    lib = _build.load()
    with torch.cuda.device(Mmin.device):
        err = lib.sbz_pass2_min(
            Mmin.data_ptr(), sdphi2.data_ptr(), po.data_ptr(), rows,
            out.data_ptr(), h, w, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pass2_min_cuda")
    pass2_min_cuda.launches += 1
    return out


pass2_min_cuda.launches = 0


def pass2_min_two_cuda(Mmin, Mmax, sdphi2, po, k: int):
    """The two-extremum form of B2: amin (h, w) = min over the lat window
    of sdphi2 + min(po * Mmin, po * Mmax), BIG where Mmin is BIG, for
    tables whose po may be negative (``pass1_extrema(need_max=True)``
    gives both extrema).  Shapes as :func:`pass2_min_cuda`, ``Mmax`` as
    ``Mmin``.

    Precondition, which pass 1's extrema meet: where Mmin <= BIG/2 (a
    window with coast), -BIG/2 <= Mmin <= Mmax <= BIG/2; where Mmin >
    BIG/2, |Mmax| > BIG/2 (pass 1's -BIG, or BIG where Mmax is a copy of
    Mmin).  Under it the kernel's result is the plain version's bit for
    bit, though its pruned build reads one extremum a tap: Mmin where po
    >= 0 and Mmax where po < 0.

    A CUDA tensor launches the kernel on the current stream (its staged
    build up to :func:`pass2_min_two_limits`; past it the routine of
    ``csrc/pass2_pruned.cuh`` with an exact early exit, after two small
    launches that build its bound into device scratch allocated here),
    counted once a call in ``pass2_min_two_cuda.launches``; a CPU tensor
    takes the plain version, ``ops.distance.pass2_min(..., Mmax=Mmax)``."""
    k = int(k)
    if Mmin.device.type == "cpu":
        return pass2_min(Mmin, sdphi2, po, k, Mmax=Mmax)
    h, w = _require_pass2(Mmin, sdphi2, po, k)
    _build.require(Mmax, "Mmax", (h + 2 * k, w), Mmin.device)
    out = torch.empty((h, w), dtype=torch.float32, device=Mmin.device)
    lib = _build.load()
    floats = ctypes.c_longlong()
    lib.sbz_pass2_min_two_scratch(h, w, k, ctypes.byref(floats))
    scratch = (torch.empty(floats.value, dtype=torch.float32,
                           device=Mmin.device) if floats.value else None)
    with torch.cuda.device(Mmin.device):
        err = lib.sbz_pass2_min_two(
            Mmin.data_ptr(), Mmax.data_ptr(), sdphi2.data_ptr(),
            po.data_ptr(), out.data_ptr(), h, w, k,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pass2_min_two_cuda")
    pass2_min_two_cuda.launches += 1
    return out


pass2_min_two_cuda.launches = 0


def _read_limit(name: str) -> int:
    value = ctypes.c_int()
    getattr(_build.load(), name)(ctypes.byref(value))
    return value.value


@functools.cache
def pass2_min_limits() -> int:
    """The widest radius k of kernel B2's staged build (MAX_STAGED_K in
    csrc/pass2_min.cu: its strip of (16+2k) x 128 floats grows with k);
    wider k runs the unstaged build.  Read from the built kernels, which
    it builds at the first call."""
    return _read_limit("sbz_pass2_min_limits")


@functools.cache
def pass2_min_two_limits() -> int:
    """The widest radius k of the two-extremum form's staged build
    (MAX_STAGED_K2 in csrc/pass2_min.cu: it stages two strips, Mmin and
    Mmax, so it stops at a narrower k than :func:`pass2_min_limits`, and a
    measured crossover keeps it to there); wider k runs the routine of
    ``csrc/pass2_pruned.cuh`` with its exact early exit.  Read from the
    built kernels, which it builds at the first call."""
    return _read_limit("sbz_pass2_min_two_limits")


@functools.cache
def pruned_layout() -> tuple[int, int]:
    """``(cols_per_lane, group)`` of the wide-radius builds' pass 2
    (``csrc/pass2_pruned.cuh``): a warp owns 32 * cols_per_lane columns of
    a row and votes on its early exit every ``group`` steps of j.  Read
    from the built kernels, which it builds at the first call."""
    vals = [ctypes.c_int() for _ in range(2)]
    _build.load().sbz_pass2_min_layout(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


@functools.cache
def min_haversine_limits() -> int:
    """The widest radius k of kernel B3's builds that stage in shared
    memory (MAX_K in csrc/min_haversine.cu: their shared memory grows
    linearly in k); wider k runs the large build, pass 1 into device
    scratch and then the pass 2 of ``csrc/pass2_pruned.cuh``.  Read from
    the built kernels, which it builds at the first call."""
    return _read_limit("sbz_min_haversine_limits")


def min_haversine_param_cuda(cpad, sdphi2, po, sdlam2, k: int, *,
                             monotone=None, row_monotone=None):
    """amin (h, w): the winning haversine parameter over the (2k+1)^2
    window, BIG where no coast cell is in reach.

    ``cpad`` (h+2k, w+2k) from ``ops.distance.pad_coast``; ``sdphi2``/``po``
    (h, 2k+1), ``sdlam2`` (w, 2k+1) from ``ops.distance.distance_tables``;
    float32, contiguous.  ``monotone``: the columns' flags of
    ``ops.distance.DistanceTables`` (uint8, (w,)), or None, which takes no
    column to have the property (the kernel's loop over every coast bit of
    the window, the same result); only the builds up to
    :func:`min_haversine_limits` read it, and the large build ignores it
    unchecked (it finds each column's monotone pieces itself).
    ``row_monotone``: the rows' flags (uint8, (h,)), which only the large
    build's pass 2 reads, or None (every tap, the same result).  A CUDA
    tensor launches the kernel on the current stream (counted once a call
    in ``min_haversine_param_cuda.launches``): k past
    :func:`min_haversine_limits` takes the large build, three launches
    (the columns' pieces, pass 1, pass 2), with device scratch allocated
    here.  A CPU tensor takes the plain version.
    """
    k = int(k)
    if cpad.device.type == "cpu":
        return min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k)
    dev = cpad.device
    h, w = cpad.shape[0] - 2 * k, cpad.shape[1] - 2 * k
    _build.require(cpad, "cpad", (h + 2 * k, w + 2 * k), dev)
    _build.require(sdphi2, "sdphi2", (h, 2 * k + 1), dev)
    _build.require(po, "po", (h, 2 * k + 1), dev)
    _build.require(sdlam2, "sdlam2", (w, 2 * k + 1), dev)
    large = k > min_haversine_limits()
    cols = None if large else _flags(monotone, "monotone", w, dev)
    rows = _flags(row_monotone, "row_monotone", h, dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _build.load()
    tabs = (cpad.data_ptr(), sdphi2.data_ptr(), po.data_ptr(),
            sdlam2.data_ptr())
    shape = (out.data_ptr(), h, w, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if not large:
            err = lib.sbz_min_haversine(*tabs, cols, *shape, stream)
        else:
            floats = ctypes.c_longlong()
            err = lib.sbz_min_haversine_scratch(h, w, k,
                                                ctypes.byref(floats))
            if not err:
                scratch = torch.empty(floats.value, dtype=torch.float32,
                                      device=dev)
                err = lib.sbz_min_haversine_large(
                    *tabs, rows, *shape, scratch.data_ptr(), stream)
    _build.check(err, "min_haversine_param_cuda")
    min_haversine_param_cuda.launches += 1
    return out


min_haversine_param_cuda.launches = 0
