"""Signed distance-to-coast transform (reference ``get_dist``,
``sobel.f90:91-193``).

Counterpart of ``seabreeze_param_tpu.ops.distance``, single-extremum form
only.  The haversine parameter decomposes into per-axis host tables,

    a(y, x, di, dj) = sdphi2[y, di] + po[y, di] * sdlam2[x, dj],

and because ``po >= 0`` (clamped in :func:`distance_tables`) the minimum
over the (2k+1)^2 window separates into two passes:

* pass 1, per padded row: Mmin[r, x] = min over coast cells of sdlam2[x, dj]
  (plain torch ops — XLA fused it on the TPU, no kernel to port);
* pass 2, per target row: amin[y, x] = min_di sdphi2[y, di] + po[y, di] *
  Mmin[y + di, x].  :func:`pass2_min` here is the plain version of kernel
  B2 (``ops/cuda/distance_kernel.py``), and
  :func:`min_haversine_param_from_padded` (both passes) that of kernel B3;
  :func:`coast_distance` picks one by ``impl``.

The transcendentals run once, on the winner (:func:`finalize_distance`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.grid import EARTH_RADIUS_KM, Grid
from .indexing import lon_index_periodic, pad_indices

BIG_PARAM = np.float32(1.0e30)
_SENTINEL = np.float32(12000.0)


def distance_tables(grid: Grid, k: int):
    """Host-side float32 tables for the decomposed haversine parameter
    (a NumPy copy of the JAX package's).

    Returns (sdphi2, po, sdlam2):
      sdphi2 : (nlat, 2k+1)  sin^2((phi[y+di] - phi[y]) / 2); BIG at rows
               where y+di falls outside the grid.
      po     : (nlat, 2k+1)  cos(phi[y+di]) * cos(phi[y]), clamped >= 0;
               0 at invalid rows.
      sdlam2 : (nlon, 2k+1)  sin^2((lon_b[(x+dj) % n] - lon_b[x]) / 2).
    """
    phi = grid.phi.astype(np.float32)
    lonb = grid.lon_branched.astype(np.float32)
    nlat, nlon = grid.nlat, grid.nlon
    offs = np.arange(-k, k + 1)

    ysrc = np.arange(nlat)[:, None] + offs[None, :]
    row_valid = (ysrc >= 0) & (ysrc < nlat)
    ysrc_c = np.clip(ysrc, 0, nlat - 1)
    dphi = (phi[ysrc_c] - phi[:, None]).astype(np.float32)
    sdphi2 = np.sin(dphi / np.float32(2.0), dtype=np.float32) ** 2
    po = (np.cos(phi[ysrc_c], dtype=np.float32)
          * np.cos(phi[:, None], dtype=np.float32)).astype(np.float32)
    # cos*cos >= 0 on [-90, 90] deg in exact arithmetic; the f32 rounding of
    # the 90-deg radian gives ~-4.4e-8 at exact pole rows.  The clamp keeps
    # the pass-1 window minimum attained at Mmin alone.
    po = np.maximum(po, np.float32(0.0))
    sdphi2 = np.where(row_valid, sdphi2, BIG_PARAM).astype(np.float32)
    po = np.where(row_valid, po, np.float32(0.0)).astype(np.float32)

    xsrc = (np.arange(nlon)[:, None] + offs[None, :]) % nlon
    dlam = (lonb[xsrc] - lonb[:, None]).astype(np.float32)
    sdlam2 = np.sin(dlam / np.float32(2.0), dtype=np.float32) ** 2
    return sdphi2, po, sdlam2


def effective_radius(grid: Grid, maxdist: float, k: int | None = None) -> int:
    """The reference's k (sobel.f90:137), bounded to sane values."""
    if k is None:
        k = grid.search_radius_cells(maxdist)
    return max(0, min(k, max(grid.nlat, grid.nlon)))


def pad_coast(coast, k: int):
    """Zero rows beyond the lat edges, periodic columns: (h+2k, w+2k)."""
    cols = pad_indices(coast.shape[1], k, lon_index_periodic)
    return F.pad(coast, (0, 0, k, k)).index_select(
        1, torch.as_tensor(cols, device=coast.device))


def pass1_extrema(cpad, sdlam2, k: int):
    """Pass 1: per padded row, the masked sliding min of sdlam2 over the lon
    window.  ``cpad`` (h+2k, w+2k), ``sdlam2`` (w, 2k+1) -> Mmin (h+2k, w),
    BIG where the window holds no coast cell."""
    w = cpad.shape[1] - 2 * k
    mmin = torch.full((cpad.shape[0], w), float(BIG_PARAM),
                      dtype=torch.float32, device=cpad.device)
    for dj in range(2 * k + 1):
        win = cpad[:, dj:dj + w] > 0.0
        cand = sdlam2[:, dj][None, :]
        mmin = torch.where(win, torch.minimum(mmin, cand), mmin)
    return mmin


def pass2_min(Mmin, sdphi2, po, k: int):
    """Pass 2, the plain version of kernel B2: per target row, the min over
    the lat window of sdphi2 + po * Mmin, BIG where the row window holds no
    coast source.  ``Mmin`` (h+2k, w), ``sdphi2``/``po`` (h, 2k+1) ->
    amin (h, w).  The multiply and the add are two rounded ops."""
    h = Mmin.shape[0] - 2 * k
    big = float(BIG_PARAM)
    amin = torch.full((h, Mmin.shape[1]), big, dtype=torch.float32,
                      device=Mmin.device)
    for di in range(2 * k + 1):
        lo = Mmin[di:di + h]
        cand = sdphi2[:, di:di + 1] + po[:, di:di + 1] * lo
        cand = torch.where(lo > big / 2, big, cand)
        amin = torch.minimum(amin, cand)
    return amin


def finalize_distance(amin, lsm, maxdist):
    """Winning haversine parameter -> signed, capped cdist.  The sign comes
    from the raw land fraction at the target (sobel.f90:179)."""
    found = amin < float(BIG_PARAM) / 2
    a = torch.clamp(amin, 0.0, 1.0)
    c = (float(EARTH_RADIUS_KM * np.float32(2.0))
         * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a)) + 0.5)
    sign = torch.where(lsm > 0.0, 1.0, -1.0)
    sent = float(_SENTINEL)
    cdist = torch.where(found & (c < sent), sign * c, sent)
    # sobel.f90:188 — cap at 2*maxdist else sentinel
    return torch.where(cdist.abs() > float(np.float32(2.0)
                                           * np.float32(maxdist)),
                       sent, cdist)


def min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k: int):
    """Both passes on a k-padded coast field (:func:`pad_coast`): the plain
    version of kernel B3.  Returns amin (h, w)."""
    return pass2_min(pass1_extrema(cpad, sdlam2, k), sdphi2, po, k)


def window_monotone(table, k: int):
    """(n,) bool: the rows of ``table`` (n, 2k+1) that do not increase from
    either end of the window to its centre tap k (non-increasing over taps
    0..k, non-decreasing over k..2k).

    Where the row of sdlam2 for a column has it, pass 1's masked minimum
    there is the smaller of the row's values at the nearest coast tap at or
    left of the centre and at or right of it, which kernel B3 finds by a
    scan of coast bits instead of 2k+1 taps.  A global uniform grid's every
    column has it, a regional grid's every column but those within k of its
    seam (where the periodic wrap jumps by the domain's width).  Where a row
    of sdphi2 has it, the wide-radius builds' pass 2 may stop once no
    column's minimum is above the least sdphi2 still to come
    (``csrc/pass2_pruned.cuh``); a grid with monotone latitudes has it in
    every row, the rows out of range (BIG) at the lat edges included."""
    t = np.asarray(table)
    return ((np.diff(t[:, :k + 1], axis=1) <= 0).all(axis=1)
            & (np.diff(t[:, k:], axis=1) >= 0).all(axis=1))


class DistanceTables(tuple):
    """``(sdphi2, po, sdlam2)`` as float32 tensors on one device, with the
    flags of :func:`window_monotone` as uint8 tensors: ``monotone`` (length
    w, nonzero where the column's row of sdlam2 has the property) and
    ``row_monotone`` (length h, the rows of sdphi2).  Unpacks as the three
    tables."""

    def __new__(cls, sdphi2, po, sdlam2, monotone, row_monotone):
        tabs = super().__new__(cls, (sdphi2, po, sdlam2))
        tabs.monotone = monotone
        tabs.row_monotone = row_monotone
        return tabs

    def select(self, rows, cols):
        """The tables of a block of the field: the rows ``rows`` of sdphi2
        and po (with their flags) and the columns ``cols`` (rows of sdlam2,
        with their flags), each a slice or an index tensor."""
        def pick(t, idx):
            return t[idx] if isinstance(idx, slice) else t.index_select(0, idx)
        sdphi2, po, sdlam2 = self
        return DistanceTables(pick(sdphi2, rows), pick(po, rows),
                              pick(sdlam2, cols), pick(self.monotone, cols),
                              pick(self.row_monotone, rows))


def device_tables(grid: Grid, k: int, device):
    """:func:`distance_tables` as a :class:`DistanceTables` on ``device``,
    the monotone flags of its columns (sdlam2) and rows (sdphi2) checked
    here, once."""
    sdphi2, po, sdlam2 = distance_tables(grid, k)
    cols = window_monotone(sdlam2, k).astype(np.uint8)
    rows = window_monotone(sdphi2, k).astype(np.uint8)
    return DistanceTables(*(torch.as_tensor(t, device=device)
                            for t in (sdphi2, po, sdlam2, cols, rows)))


IMPLS = ("auto", "hybrid", "fused", "plain")


def resolve_impl(impl: str, device) -> str:
    """``'auto'`` is ``'fused'`` on the card and ``'plain'`` elsewhere.

    The JAX package takes the hybrid on the TPU, where its fused kernel
    lost; on an H100 B3 is ahead of the hybrid's torch pass 1 + B2 end to
    end on every grid measured, in pairs of fresh processes (PERF.md)."""
    if impl not in IMPLS:
        raise ValueError(f"distance impl {impl!r}: want one of {IMPLS}")
    if impl != "auto":
        return impl
    return "fused" if torch.device(device).type == "cuda" else "plain"


def coast_distance(coast, lsm, grid: Grid, maxdist: float = 180.0, *,
                   k: int | None = None, tables=None, impl: str = "auto"):
    """Full ``get_dist`` equivalent: signed km distance to the nearest
    coastline cell, positive over land, negative over sea, 12000 km sentinel
    beyond 2*maxdist.

    ``tables`` — :func:`device_tables` for this grid and k, so a caller
    looping over steps builds them once.  ``impl`` — the gather-min:

    * ``'hybrid'``: torch pass 1, then kernel B2 for pass 2;
    * ``'fused'``: kernel B3, both passes in one kernel;
    * ``'plain'``: both passes as torch ops;
    * ``'auto'`` (default): ``'fused'`` on the card, ``'plain'`` on the
      CPU.

    The JAX package's names: ``'xla'`` is ``'plain'``, ``'pallas'`` is
    ``'fused'``.  A kernel wrapper handed a CPU tensor takes its plain
    version, so every choice gives the plain result on the CPU.
    """
    k_eff = effective_radius(grid, maxdist, k)
    if tables is None:
        tables = device_tables(grid, k_eff, coast.device)
    return coast_distance_from_padded(pad_coast(coast, k_eff), lsm, tables,
                                      k_eff, maxdist, impl=impl)


def coast_distance_from_padded(cpad, lsm, tables, k: int,
                               maxdist: float = 180.0, *, impl: str = "auto"):
    """The signed distance of one block from its k-padded coast ``cpad``
    (h+2k, w+2k) and the block's own table rows and columns ``tables`` =
    (sdphi2 (h, 2k+1), po (h, 2k+1), sdlam2 (w, 2k+1)), contiguous, with
    the flags of a :class:`DistanceTables` where it is one; ``impl`` as in
    :func:`coast_distance`.  A decomposed run's shards call it with
    an exchanged or apron-computed pad and their slices of the tables."""
    sdphi2, po, sdlam2 = tables
    rows = getattr(tables, "row_monotone", None)
    impl = resolve_impl(impl, cpad.device)
    if impl == "fused":
        from .cuda.distance_kernel import min_haversine_param_cuda
        amin = min_haversine_param_cuda(
            cpad, sdphi2, po, sdlam2, k,
            monotone=getattr(tables, "monotone", None), row_monotone=rows)
    elif impl == "hybrid":
        from .cuda.distance_kernel import pass2_min_cuda
        amin = pass2_min_cuda(pass1_extrema(cpad, sdlam2, k), sdphi2, po, k,
                              row_monotone=rows)
    else:
        amin = min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k)
    return finalize_distance(amin, lsm, maxdist)
