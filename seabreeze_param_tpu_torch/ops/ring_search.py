"""Expanding-ring thermal-heating-contrast search (reference
``seabreeze_diag_python.f90:187-221``); counterpart of
``seabreeze_param_tpu.ops.ring_search``.

Per coastal cell, grow a square window nn = 1, 2, ... until it holds both a
land cell (cdist >= 0, the +12000 sentinel included) and a sea cell, then
n_thc = mul * (mean t0 over land - mean t0 over sea).  The window sums grow
incrementally (a horizontal and a vertical running sum), and each cell
latches its sums at the first radius that holds both classes.

:func:`ring_thc_from_padded` is, with ``ops.trigger.trigger_cells``, the
plain version of kernels B1 and B4 (``ops/cuda/ring_kernel.py``), and alone
the plain version of kernel B5; the kernels keep its summation order
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .indexing import (lat_index_clamped, lon_index_periodic,
                       lon_index_quirky, pad2d, pad_indices)


def required_ring_radius_host(cdist, maxdist, *, exact_lon: bool = True,
                              cap: int | None = None) -> int:
    """Host-side exact bound for the expanding-ring radius (a NumPy copy of
    the JAX package's).

    For every cell with |cdist| <= maxdist, the smallest nn whose window
    holds both cdist classes; returns the maximum over cells, at most
    ``cap`` (default max(nlat, nlon)).  The ring window of radius nn is the
    Chebyshev ball, so the required nn is the larger Chebyshev distance to
    the nearest cell of either class, on a frame padded by ``cap`` through
    the boundary maps.  A result below ``cap`` is exact.
    """
    try:
        from scipy.ndimage import distance_transform_cdt
    except ImportError:
        distance_transform_cdt = None

    cdist = np.asarray(cdist)
    nlat, nlon = cdist.shape
    if cap is None:
        cap = max(nlat, nlon)
    land = cdist >= 0.0
    target = np.abs(cdist) <= np.float32(maxdist)
    if not target.any():
        return 1
    rows = pad_indices(nlat, cap, lat_index_clamped)
    cols = pad_indices(nlon, cap,
                       lon_index_quirky if exact_lon else lon_index_periodic)
    Lp = land[rows][:, cols]

    def _cheb_dist(zero_set):
        """Chessboard distance to the nearest True cell of ``zero_set``."""
        if distance_transform_cdt is not None:
            return distance_transform_cdt(~zero_set, metric="chessboard")
        reached = zero_set.copy()
        dist = np.where(reached, 0, np.iinfo(np.int32).max)
        for r in range(1, int(cap) + 1):
            if reached.all():
                break
            grown = reached.copy()
            grown[1:, :] |= reached[:-1, :]
            grown[:-1, :] |= reached[1:, :]
            grown[:, 1:] |= reached[:, :-1]
            grown[:, :-1] |= reached[:, 1:]
            grown[1:, 1:] |= reached[:-1, :-1]
            grown[1:, :-1] |= reached[:-1, 1:]
            grown[:-1, 1:] |= reached[1:, :-1]
            grown[:-1, :-1] |= reached[1:, 1:]
            dist[grown & ~reached] = r
            reached = grown
        return dist

    r_land = _cheb_dist(Lp)
    r_sea = _cheb_dist(~Lp)
    ctr = (slice(cap, cap + nlat), slice(cap, cap + nlon))
    need = np.maximum(np.maximum(r_land[ctr], r_sea[ctr]), 1)
    return int(min(cap, need[target].max()))


def ring_quantities(t0, cdist):
    """The three window summands t0*land, land, t0*sea, stacked (3, h, w).
    The sea count is (2nn+1)^2 - n_land, exact in float32."""
    land = (cdist >= 0.0).to(torch.float32)
    tl = t0 * land
    return torch.stack([tl, land, t0 - tl])


def ring_thc_from_padded(P, mul, nn_max: int, *, coastal=None):
    """Incremental box-sum search on an NN-padded quantity stack.

    P   : (3, h+2NN, w+2NN) padded :func:`ring_quantities` stack.
    mul : (h, w) — +1 land targets / -1 sea targets.
    coastal : optional (h, w) bool; non-coastal outputs are zeroed.
    Returns (n_thc, found).
    """
    NN = int(nn_max)
    h = P.shape[1] - 2 * NN
    w = P.shape[2] - 2 * NN

    W = P[:, NN:NN + h, NN:NN + w]
    Hp = P[:, :, NN:NN + w]
    Vc = P[:, NN:NN + h, :]

    dev = P.device
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    Tl = torch.zeros((h, w), dtype=torch.float32, device=dev)
    Nl = torch.ones((h, w), dtype=torch.float32, device=dev)
    Ts = torch.zeros((h, w), dtype=torch.float32, device=dev)
    Ns = torch.ones((h, w), dtype=torch.float32, device=dev)

    for nn in range(1, NN + 1):
        Hp = Hp + P[:, :, NN - nn:NN - nn + w] + P[:, :, NN + nn:NN + nn + w]
        top = Hp[:, NN - nn:NN - nn + h, :]
        bot = Hp[:, NN + nn:NN + nn + h, :]
        left = Vc[:, :, NN - nn:NN - nn + w]
        right = Vc[:, :, NN + nn:NN + nn + w]
        W = W + top + bot + left + right
        Vc = Vc + P[:, NN - nn:NN - nn + h, :] + P[:, NN + nn:NN + nn + h, :]

        t_l, n_l, t_s = W[0], W[1], W[2]
        n_s = float((2 * nn + 1) ** 2) - n_l
        ok = (n_l > 0.0) & (n_s > 0.0)
        last = (ok | (nn == NN)) & ~found
        Tl = torch.where(last, t_l, Tl)
        Nl = torch.where(last, torch.clamp_min(n_l, 1.0), Nl)
        Ts = torch.where(last, t_s, Ts)
        Ns = torch.where(last, torch.clamp_min(n_s, 1.0), Ns)
        found = found | ok

    n_thc = mul * (Tl / Nl - Ts / Ns)
    if coastal is not None:
        n_thc = torch.where(coastal, n_thc, 0.0)
    return n_thc, found


def ring_thc(t0, cdist, nn_max: int, *, exact_lon: bool = True,
             maxdist: float | None = None):
    """Expanding-ring THC of an unpadded (t0, cdist) pair: pad the quantity
    stack through the boundary maps, then :func:`ring_thc_from_padded`.
    With ``maxdist`` the output is zero off the band |cdist| <= maxdist.
    Returns (n_thc, found)."""
    NN = int(nn_max)
    P = pad2d(ring_quantities(t0, cdist), NN, NN, exact_lon=exact_lon)
    mul = torch.where(cdist >= 0.0, 1.0, -1.0)
    coastal = None if maxdist is None else (
        cdist.abs() <= float(np.float32(maxdist)))
    return ring_thc_from_padded(P, mul, NN, coastal=coastal)
