"""NumPy models of the wide-radius distance builds' pass 2
(``seabreeze_param_tpu_torch/csrc/pass2_pruned.cuh``), on the host.

The card's kernels B2 (unstaged build, k > 175) and B3 (large build, k >
354) visit a window's taps centre-out and leave once no column's minimum
is above the least sdphi2 still to come, on the rows of sdphi2 that
``ops.distance.device_tables`` flags (``row_monotone``).  These models give
the same output as ``ops.distance.pass2_min`` and count the taps:

* :func:`pass2_centre_out`: the kernels' own schedule (warps, groups of
  steps, clamped repeats), for the taps a warp takes;
* :func:`pass2_least_taps`: each column on its own with no repeats, the
  least an exact exit of this kind needs, from which ``chip_smoke.py``
  counts the operations of these builds' bound.

Used by ``chip_smoke.py`` and ``tests/test_torch_pruned_distance.py``.
"""
from __future__ import annotations

import numpy as np

from seabreeze_param_tpu_torch.ops.distance import BIG_PARAM


def _inputs(Mmin, sdphi2, po, k, row_monotone):
    m, t, q = (np.asarray(a, dtype=np.float32) for a in (Mmin, sdphi2, po))
    mono = (np.zeros(m.shape[0] - 2 * k, bool) if row_monotone is None
            else np.asarray(row_monotone).astype(bool))
    return m, t, q, mono


def _window_has_coast(m, k):
    """(h,) bool: whether an output row's 2k+1 window rows hold a coast
    (some Mmin below BIG/2: kernel B3's row flags from its pass 1)."""
    rows = (m < BIG_PARAM / 2).any(axis=1)
    win = np.lib.stride_tricks.sliding_window_view(rows, 2 * k + 1)
    return win.any(axis=1)


def _candidate(m, t, q, k, d):
    """The candidates of tap k + d for every output cell: sdphi2 + po *
    Mmin, each rounded (no fused multiply-add), BIG where Mmin is."""
    h = m.shape[0] - 2 * k
    lo = m[k + d:k + d + h]
    cand = t[:, k + d, None] + q[:, k + d, None] * lo
    return np.where(lo > BIG_PARAM / 2, BIG_PARAM, cand)


def pass2_centre_out(Mmin, sdphi2, po, k: int, row_monotone=None, *,
                     band: int = 32, group: int = 8, skip_empty=False):
    """The schedule of the kernels: one warp per output row and ``band``
    columns visits the taps centre-out in groups of ``group`` steps (k,
    then k -+ 1, ...; the first group holds the centre twice, steps past
    k are taken at k) and, on a row that ``row_monotone`` flags, leaves
    after a group once no column's minimum is above the least sdphi2 still
    to come.  With ``skip_empty`` a warp whose window rows hold no coast
    takes no tap (kernel B3's row flags).

    Returns ``(amin, taps)``: amin (h, w), which equals ``pass2_min``'s
    bit for bit where the flags hold, and the taps each warp took, (h,
    ceil(w / band)), repeats included (2 * group a group)."""
    m, t, q, mono = _inputs(Mmin, sdphi2, po, k, row_monotone)
    h, w = m.shape[0] - 2 * k, m.shape[1]
    nb = -(-w // band)
    acc = np.full((h, w), BIG_PARAM, np.float32)
    active = np.ones((h, nb), bool)
    if skip_empty:
        active &= _window_has_coast(m, k)[:, None]
    taps = np.zeros((h, nb), np.int64)

    def tap(d):
        lanes = np.repeat(active, band, axis=1)[:, :w]
        np.copyto(acc, np.minimum(acc, _candidate(m, t, q, k, d)),
                  where=lanes)
        taps[active] += 1

    for j in range(0, k + 1, group):
        for d in range(j, j + group):
            tap(-min(d, k))
            tap(min(d, k))
        nj = j + group
        if nj > k:
            break
        bound = np.minimum(t[:, k - nj], t[:, k + nj])[:, None]
        need = np.zeros((h, nb * band), bool)
        need[:, :w] = acc > bound
        active &= ~mono[:, None] | need.reshape(h, nb, band).any(axis=2)
        if not active.any():
            break
    return acc, taps


def pass2_least_taps(Mmin, sdphi2, po, k: int, row_monotone=None, *,
                     skip_empty=False):
    """The taps an exact centre-out exit needs in each output cell: the
    centre, then k -+ 1, ... (1 + 2j taps through step j), each column on
    its own, leaving after the first step j whose minimum is no larger
    than the least sdphi2 still to come, min(sdphi2[k-j-1],
    sdphi2[k+j+1]), on a row that ``row_monotone`` flags; all 2k+1 taps on
    the other rows; none with ``skip_empty`` where the window rows hold no
    coast.  No warp, group or repeat.

    Returns ``(amin, taps)``: amin (h, w), ``pass2_min``'s bit for bit
    where the flags hold, and the taps of each cell, (h, w)."""
    m, t, q, mono = _inputs(Mmin, sdphi2, po, k, row_monotone)
    h, w = m.shape[0] - 2 * k, m.shape[1]
    acc = np.full((h, w), BIG_PARAM, np.float32)
    live = np.ones((h, w), bool)
    if skip_empty:
        live &= _window_has_coast(m, k)[:, None]
    taps = np.zeros((h, w), np.int64)
    for j in range(k + 1):
        for d in ((0,) if j == 0 else (-j, j)):
            np.copyto(acc, np.minimum(acc, _candidate(m, t, q, k, d)),
                      where=live)
            taps += live
        if j == k:
            break
        bound = np.minimum(t[:, k - j - 1], t[:, k + j + 1])[:, None]
        live &= ~mono[:, None] | (acc > bound)
        if not live.any():
            break
    return acc, taps
