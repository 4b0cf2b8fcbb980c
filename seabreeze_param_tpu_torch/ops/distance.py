"""Signed distance-to-coast transform (reference ``get_dist``,
``sobel.f90:91-193``).

Counterpart of ``seabreeze_param_tpu.ops.distance``.  The haversine
parameter decomposes into per-axis host tables,

    a(y, x, di, dj) = sdphi2[y, di] + po[y, di] * sdlam2[x, dj],

and because ``po >= 0`` (clamped in :func:`distance_tables`) the minimum
over the (2k+1)^2 window separates into two passes:

* pass 1, per padded row: Mmin[r, x] = min over coast cells of sdlam2[x, dj]
  (plain torch ops — XLA fused it on the TPU, no kernel to port), by its
  2k+1 taps (:func:`pass1_extrema`, the exact form) or, on a uniform global
  lon axis, from the nearest coast cell found by min-plus doubling
  (:func:`pass1_extrema_nearest`, ``lon_form='nearest'``);
* pass 2, per target row: amin[y, x] = min_di sdphi2[y, di] + po[y, di] *
  Mmin[y + di, x].  :func:`pass2_min` here is the plain version of kernel
  B2 (``ops/cuda/distance_kernel.py``), and
  :func:`min_haversine_param_from_padded` (both passes) that of kernel B3;
  :func:`coast_distance` picks one by ``impl``.

For tables whose po may be negative, pass 1 also gives the window maxima
(``need_max=True``) and pass 2 takes min(po * Mmin, po * Mmax) a tap (the
two-extremum form, ``Mmax=``), as in the JAX package.

The transcendentals run once, on the winner (:func:`finalize_distance`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.grid import DEG2RAD_F32, EARTH_RADIUS_KM, Grid
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


def pass1_extrema(cpad, sdlam2, k: int, *, need_max: bool = False):
    """Pass 1: per padded row, the masked sliding min (and, with
    ``need_max``, max) of sdlam2 over the lon window.  ``cpad`` (h+2k,
    w+2k), ``sdlam2`` (w, 2k+1) -> ``(Mmin, Mmax)``, each (h+2k, w), BIG /
    -BIG where the window holds no coast cell; ``Mmax`` is None without
    ``need_max`` (po >= 0 makes Mmin alone enough)."""
    w = cpad.shape[1] - 2 * k
    big = float(BIG_PARAM)
    shape = (cpad.shape[0], w)
    mmin = torch.full(shape, big, dtype=torch.float32, device=cpad.device)
    mmax = (torch.full(shape, -big, dtype=torch.float32, device=cpad.device)
            if need_max else None)
    for dj in range(2 * k + 1):
        win = cpad[:, dj:dj + w] > 0.0
        cand = sdlam2[:, dj][None, :]
        mmin = torch.where(win, torch.minimum(mmin, cand), mmin)
        if need_max:
            mmax = torch.where(win, torch.maximum(mmax, cand), mmax)
    return mmin, mmax


def pass1_extrema_nearest(cpad, k: int, half_dlam):
    """Pass 1 on a uniform global lon axis (``lon_form='nearest'``): there
    ``sdlam2[x, dj] = sin^2(|dj - k| * dlam / 2)`` rises with the offset's
    magnitude (k * dlam <= 180 deg, checked by :func:`uniform_half_dlam`),
    so the window's minimum sits at the nearest coast cell within +-k.  Its
    cell distance comes from bidirectional min-plus doubling on ``d = 0``
    at coast, BIG elsewhere: ``d = min(d, d[x-s] + s, d[x+s] + s)`` for s =
    1, 2, 4, ... until the reach covers k; then ``sin^2(d * half_dlam)``
    where ``d <= k``, BIG elsewhere.  Equal to the tapped form up to the
    float32 rounding of the branched-longitude differences (allclose, not
    bit-exact).  Returns ``(Mmin, None)``, as :func:`pass1_extrema`."""
    h2k, w2k = cpad.shape
    w = w2k - 2 * k
    big = float(BIG_PARAM)
    d = torch.where(cpad > 0.0, 0.0, big).to(torch.float32)
    s, reach = 1, 0
    while reach < k:
        edge = torch.full((h2k, s), big, dtype=torch.float32,
                          device=cpad.device)
        left = torch.cat([d[:, s:], edge], dim=1)
        right = torch.cat([edge, d[:, :-s]], dim=1)
        d = torch.minimum(d, torch.minimum(left + float(s), right + float(s)))
        reach += s
        s *= 2
    dnear = d[:, k:k + w]
    smin = torch.sin(dnear * float(np.float32(half_dlam)))
    return torch.where(dnear <= float(k), smin * smin, big), None


def uniform_half_dlam(grid: Grid, k: int | None = None):
    """Half the spacing of a uniform GLOBAL lon axis in radians (float32),
    else None (a NumPy copy of the JAX package's).

    The nearest form needs ``sdlam2[x, dj]`` to depend on |dj| alone: true
    for a uniform axis spanning the full circle (the periodic wrap shifts
    the angle by exactly 360 deg, invisible to sin^2), false on a regional
    grid, whose index-periodic wrap jumps by the domain's width.  With
    ``k`` given, sin^2(d * dlam/2) must also rise over the whole +-k
    window: k * dlam <= 180 deg."""
    if grid.nlon < 2:
        return None
    lon = grid.lon.astype(np.float64)
    diffs = np.diff(lon)
    step = diffs.mean()
    # f32 coordinate vectors jitter by ~eps(360) even on nominally uniform
    # axes: accept spacing uniform to ~0.1% of a cell
    if not np.allclose(diffs, step, rtol=0, atol=1e-3 * abs(step)):
        return None
    if not np.isclose(step * grid.nlon, 360.0, rtol=1e-4):
        return None      # regional domain: its seam breaks the |dj| form
    if k is not None and k * abs(step) > 180.0:
        return None      # window wider than a half-circle
    return np.float32(np.float32(step) * DEG2RAD_F32 / np.float32(2.0))


LON_FORMS = ("taps", "nearest")


def lon_form_half_dlam(grid: Grid, k: int, lon_form: str):
    """The ``half_dlam`` of pass 1's lon form on ``grid`` at radius ``k``:
    None for ``'taps'``, :func:`uniform_half_dlam` for ``'nearest'``.
    Raises ``ValueError`` where the form does not hold (a regional axis,
    k * dlam > 180 deg) and on an unknown form, as the JAX package's
    ``coast_distance`` does."""
    if lon_form == "taps":
        return None
    if lon_form != "nearest":
        raise ValueError(f"lon_form {lon_form!r}: want one of {LON_FORMS}")
    half = uniform_half_dlam(grid, k)
    if half is None:
        raise ValueError(
            "lon_form='nearest' needs a uniform global lon axis with "
            "k*dlam <= 180 deg (monotone sin^2 window)")
    return half


def pass2_min(Mmin, sdphi2, po, k: int, *, Mmax=None):
    """Pass 2, the plain version of kernel B2: per target row, the min over
    the lat window of sdphi2 + po * Mmin, BIG where the row window holds no
    coast source.  ``Mmin`` (h+2k, w), ``sdphi2``/``po`` (h, 2k+1) ->
    amin (h, w).  With ``Mmax`` (as Mmin) the two-extremum form: a tap
    takes sdphi2 + min(po * Mmin, po * Mmax).  The multiplies and the add
    are rounded ops of their own."""
    h = Mmin.shape[0] - 2 * k
    big = float(BIG_PARAM)
    amin = torch.full((h, Mmin.shape[1]), big, dtype=torch.float32,
                      device=Mmin.device)
    for di in range(2 * k + 1):
        lo = Mmin[di:di + h]
        p = po[:, di:di + 1]
        inner = (p * lo if Mmax is None
                 else torch.minimum(p * lo, p * Mmax[di:di + h]))
        cand = sdphi2[:, di:di + 1] + inner
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


def pass1(cpad, sdlam2, k: int, half_dlam=None):
    """Pass 1 in the lon form that ``half_dlam`` names: the taps (None) or
    the nearest form.  Returns ``(Mmin, None)``."""
    if half_dlam is None:
        return pass1_extrema(cpad, sdlam2, k)
    return pass1_extrema_nearest(cpad, k, half_dlam)


def min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k: int, *,
                                    half_dlam=None):
    """Both passes on a k-padded coast field (:func:`pad_coast`): the plain
    version of kernel B3 (which takes the taps).  ``half_dlam``: pass 1 in
    the nearest form (:func:`uniform_half_dlam`).  Returns amin (h, w)."""
    Mmin, Mmax = pass1(cpad, sdlam2, k, half_dlam)
    return pass2_min(Mmin, sdphi2, po, k, Mmax=Mmax)


def min_haversine_param(coast, sdphi2, po, sdlam2, k: int):
    """Single-device form: :func:`pad_coast`, then both passes."""
    return min_haversine_param_from_padded(pad_coast(coast, k), sdphi2, po,
                                           sdlam2, k)


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
#: The JAX package's names of the same choices.
IMPL_ALIASES = {"xla": "plain", "pallas": "fused"}


def resolve_impl(impl: str, device, lon_form: str = "taps") -> str:
    """``'auto'`` is ``'fused'`` on the card and ``'plain'`` elsewhere;
    with ``lon_form='nearest'`` it is ``'hybrid'`` on the card, so that the
    form asked for is the form computed (B3 takes the taps).  The JAX
    package's ``'xla'`` is ``'plain'`` and its ``'pallas'`` ``'fused'``.

    The JAX package takes the hybrid on the TPU, where its fused kernel
    lost; on an H100 B3 is ahead of the hybrid's torch pass 1 + B2 end to
    end on every grid measured, in pairs of fresh processes (PERF.md)."""
    impl = IMPL_ALIASES.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"distance impl {impl!r}: want one of {IMPLS} "
                         f"(or the JAX package's {tuple(IMPL_ALIASES)})")
    if impl != "auto":
        return impl
    if torch.device(device).type != "cuda":
        return "plain"
    return "hybrid" if lon_form == "nearest" else "fused"


def coast_distance(coast, lsm, grid: Grid, maxdist: float = 180.0, *,
                   k: int | None = None, tables=None, impl: str = "auto",
                   lon_form: str = "taps"):
    """Full ``get_dist`` equivalent: signed km distance to the nearest
    coastline cell, positive over land, negative over sea, 12000 km sentinel
    beyond 2*maxdist.

    ``tables`` — :func:`device_tables` for this grid and k, so a caller
    looping over steps builds them once.  ``impl`` — the gather-min:

    * ``'hybrid'``: torch pass 1, then kernel B2 for pass 2;
    * ``'fused'``: kernel B3, both passes in one kernel;
    * ``'plain'``: both passes as torch ops;
    * ``'auto'`` (default): ``'fused'`` on the card (``'hybrid'`` with
      ``lon_form='nearest'``), ``'plain'`` on the CPU.

    The JAX package's names: ``'xla'`` is ``'plain'``, ``'pallas'`` is
    ``'fused'``.  ``lon_form`` — pass 1's form: ``'taps'`` (exact) or
    ``'nearest'`` (:func:`pass1_extrema_nearest`, a uniform global lon axis
    only; ``ValueError`` elsewhere, as in the JAX package).  ``'fused'``
    checks the form and runs B3's taps, as the JAX package's ``'pallas'``
    does.  A kernel wrapper handed a CPU tensor takes its plain version,
    so every choice gives the plain result on the CPU.
    """
    k_eff = effective_radius(grid, maxdist, k)
    half_dlam = lon_form_half_dlam(grid, k_eff, lon_form)
    if tables is None:
        tables = device_tables(grid, k_eff, coast.device)
    return coast_distance_from_padded(pad_coast(coast, k_eff), lsm, tables,
                                      k_eff, maxdist, impl=impl,
                                      half_dlam=half_dlam)


def coast_distance_from_padded(cpad, lsm, tables, k: int,
                               maxdist: float = 180.0, *, impl: str = "auto",
                               half_dlam=None):
    """The signed distance of one block from its k-padded coast ``cpad``
    (h+2k, w+2k) and the block's own table rows and columns ``tables`` =
    (sdphi2 (h, 2k+1), po (h, 2k+1), sdlam2 (w, 2k+1)), contiguous, with
    the flags of a :class:`DistanceTables` where it is one; ``impl`` as in
    :func:`coast_distance`; ``half_dlam``: pass 1 in the nearest form
    (:func:`lon_form_half_dlam`), None for the taps.  A decomposed run's
    shards call it with an exchanged or apron-computed pad and their
    slices of the tables."""
    sdphi2, po, sdlam2 = tables
    rows = getattr(tables, "row_monotone", None)
    impl = resolve_impl(impl, cpad.device,
                        "taps" if half_dlam is None else "nearest")
    if impl == "fused":
        from .cuda.distance_kernel import min_haversine_param_cuda
        amin = min_haversine_param_cuda(
            cpad, sdphi2, po, sdlam2, k,
            monotone=getattr(tables, "monotone", None), row_monotone=rows)
    elif impl == "hybrid":
        from .cuda.distance_kernel import pass2_min_cuda
        amin = pass2_min_cuda(pass1(cpad, sdlam2, k, half_dlam)[0], sdphi2,
                              po, k, row_monotone=rows)
    else:
        amin = min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k,
                                               half_dlam=half_dlam)
    return finalize_distance(amin, lsm, maxdist)
