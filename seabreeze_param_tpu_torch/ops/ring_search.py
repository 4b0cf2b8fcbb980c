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

from ..utils.tracing import tracer
from .indexing import pad2d


def required_ring_radius(cdist, maxdist, *, exact_lon: bool = True,
                         cap: int | None = None):
    """The exact bound for the expanding-ring radius, on ``cdist``'s
    device: for every cell with |cdist| <= maxdist, the smallest nn whose
    window holds both cdist classes; the maximum over cells, at most
    ``cap`` (default max(nlat, nlon)), as a 0-d int64 tensor there, with no
    host wait.  A result below ``cap`` is exact.  Its reference is the JAX
    package's ``required_ring_radius_host`` (two scipy chamfer transforms),
    which gives the same integer.

    On the frame padded by ``cap`` (rows clamped, columns through the
    quirky or the periodic map), an integral image counts each class in a
    square of cells with four reads.  A target's need is its Chebyshev
    distance to the nearest cell of the other class: the least r whose
    (2r + 1)^2 box around it holds one.  Every cell searches r in [0, cap]
    at once, halving a fixed range (``ceil(log2(cap + 1))`` rounds, so no
    branch on the data); a box of radius <= cap lies inside the frame.  As
    the reference: 1 without a target, 1 where the frame holds one
    class alone (scipy's transform then gives -1), else the largest need,
    at most ``cap``.
    """
    nlat, nlon = cdist.shape
    if cap is None:
        cap = max(nlat, nlon)
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")
    dev = cdist.device
    land = cdist >= 0.0
    target = cdist.abs() <= float(np.float32(maxdist))

    # the padded frame, through the maps of ops/indexing.py
    rows = torch.arange(-cap, nlat + cap, device=dev).clamp_(0, nlat - 1)
    if exact_lon:       # max(1, (j + 1) mod nlon) - 1
        cols = torch.arange(1 - cap, nlon + cap + 1, device=dev)
        cols = cols.remainder_(nlon).sub_(1).clamp_min_(0)
    else:
        cols = torch.arange(-cap, nlon + cap, device=dev).remainder_(nlon)
    lpt = land.T[cols[:, None], rows]               # the frame, transposed
    # integral images of land (plane 0) and sea (plane 1), each with a
    # leading row and column of zeros.  Both scans run along the innermost
    # dimension, with a transposing copy between: PyTorch's scan along an
    # outer one runs a thread a column, ~1.2 ms at 3073 x 3073 on an H100.
    h1, w1 = nlat + 2 * cap + 1, nlon + 2 * cap + 1
    S = torch.zeros((2, w1, h1), device=dev, dtype=(
        torch.int32 if h1 * w1 < 2**31 else torch.int64))
    S[0, 1:, 1:] = lpt
    S[1, 1:, 1:] = ~lpt
    S = S.cumsum_(2).transpose(1, 2).contiguous().cumsum_(2)

    # The box of radius r around frame cell (a, b) is S at the corners
    # [m, p]: (a + r + 1, b + r + 1) + (a - r, b - r) (m = 0) less
    # (a - r, b + r + 1) + (a + r + 1, b - r) (m = 1).  Flat, each corner
    # is base + r * step, base = g + m + p * w[m], step = (2p - 1) * w[m],
    # g the flat (a, b) in the plane of the other class than the frame's
    # at (a, b) (the quirky map puts column 0's there for column nlon-1).
    w = torch.arange(w1 + 1, w1 - 2, -2, device=dev)        # [w1+1, w1-1]
    p = torch.arange(2, device=dev)
    step = torch.outer(w, 2 * p - 1)[..., None, None]
    g = (torch.arange(cap * w1, (cap + nlat) * w1, w1, device=dev)[:, None]
         + torch.arange(cap, cap + nlon, device=dev))
    g = torch.add(g, lpt[cap:cap + nlon, cap:cap + nlat].T, alpha=h1 * w1)
    idx = g + (torch.outer(w, p) + p[:, None])[..., None, None]

    # the largest radius whose box holds no cell of the other class (0 at
    # least), in [lo, lo + n - 1]; idx holds lo's corners
    n = cap + 1
    while n > 1:
        half = n // 2
        probe = torch.add(idx, step, alpha=half)
        sums = S.take(probe).sum(1)
        idx = torch.where(sums[0] == sums[1], probe, idx)
        n -= half
    radius = (g - idx[0, 0]) // w[0]
    need = torch.where(target, radius, 0).amax() + 1
    both = S[:, -1, -1].amin() > 0
    return torch.where(both, need, 1).clamp_max_(cap)


def static_ring_bound(k: int, params) -> int:
    """The ring radius NN that holds on physically periodic grids without
    a probe: k + 2 plus ``params.ring_search_margin``, at least 3."""
    return max(3, k + 2 + params.ring_search_margin)


def ring_bound(cdist0, k: int, params) -> int:
    """The ring radius NN for a run whose first distance field is
    ``cdist0``: :func:`static_ring_bound`, or the radius
    :func:`required_ring_radius` probes on ``cdist0`` plus the margin,
    whichever is larger.  Any NN at or above the need gives the same
    answers: every target latches at its own radius.

    The probe widens its frame only as far as needed: padded by about 4k
    cells first, and doubled while the result reaches the frame (a result
    below the frame width is exact).  Each pass runs on ``cdist0``'s device
    (a host array: the CPU) under the span ``probe:transform``, reads back
    its one integer under ``wait:probe_readback``, and adds the cells of
    its frame to the counter ``probe_frame_cells``."""
    cdist0 = torch.as_tensor(cdist0)
    nlat, nlon = cdist0.shape
    full = max(nlat, nlon)
    cap = min(full, max(8, 4 * k))
    while True:
        tracer.count("probe_frame_cells", (nlat + 2 * cap) * (nlon + 2 * cap))
        with tracer.hook("probe:transform"):
            req = required_ring_radius(
                cdist0, params.maxdist, exact_lon=params.exact_lon_indexing,
                cap=cap)
            with tracer.hook("wait:probe_readback"):
                req = int(req)
        if req < cap or cap >= full:
            break
        cap = min(full, 2 * cap)
    return max(static_ring_bound(k, params),
               req + params.ring_search_margin)


def ring_quantities(t0, cdist):
    """The three window summands t0*land, land, t0*sea, stacked (3, h, w).
    The sea count is (2nn+1)^2 - n_land in float32: exact up to nn = 2047,
    rounded past it (the cell count passes 2^24), as the JAX package
    forms it."""
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
        # the cell count rounded to float32 first, as JAX forms it
        n_s = float(np.float32((2 * nn + 1) ** 2)) - n_l
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
