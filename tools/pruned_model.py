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

The two-extremum form (B2's ``sbz_pass2_min_two`` past its staged build)
reads one extremum a tap, Mmin where po >= 0 and Mmax where po < 0, and
leaves on a bound that holds for po of either sign
(:func:`two_exit_bound`); :func:`pass2_two_centre_out` and
:func:`pass2_two_least_taps` are its schedule and its least taps.
:func:`pass2_two_floor_taps` counts the taps of an exit that knows each
cell's own minimum, the least any exact centre-out exit can take whatever
its bound, from which ``chip_smoke.py`` counts the operations of the
form's bound.

Used by ``chip_smoke.py``, ``tests/test_torch_pruned_distance.py`` and
``tests/test_torch_two_extremum_exit.py``.
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


def _two_inputs(Mmin, Mmax, sdphi2, po):
    return tuple(np.asarray(a, dtype=np.float32)
                 for a in (Mmin, Mmax, sdphi2, po))


def _valid(v):
    """Where a value read by the two-extremum form counts: within
    [-BIG/2, BIG/2] (outside it the window is empty)."""
    return np.abs(v) <= BIG_PARAM / 2


def two_exit_bound(Mmin, Mmax, sdphi2, po, k: int):
    """The exit tables of the two-extremum form's pruned build, as
    ``csrc/pass2_min.cu`` builds them on the card.

    E_lo[r] is padded row r's least valid Mmin, E_hi[r] its greatest valid
    Mmax (BIG / -BIG where it holds none).  A tap di of output row y can
    give no candidate below B[y, di] = sdphi2 + po * E (E = E_lo[y+di]
    where po >= 0, E_hi[y+di] where po < 0; each op rounded; BIG where E
    is not valid; at most BIG): the value it reads lies between E and its
    sign's side, and the rounded multiply and add are monotone.  Returns
    ``(E_lo, E_hi, L)``, L (h, k+1) with L[y, j] = min over |di - k| >= j
    of B[y, di]; the card keeps the columns where its votes fall, L[:,
    ::GROUP]."""
    m, x, t, q = _two_inputs(Mmin, Mmax, sdphi2, po)
    big = np.float32(BIG_PARAM)
    e_lo = np.where(_valid(m), m, big).min(axis=1)
    e_hi = np.where(_valid(x), x, -big).max(axis=1)
    h = m.shape[0] - 2 * k
    rows = np.arange(h)[:, None] + np.arange(2 * k + 1)[None, :]
    e = np.where(q >= 0, e_lo[rows], e_hi[rows])
    b = np.where(_valid(e), np.fmin(t + q * e, big), big)
    c = np.fmin(b[:, k::-1], b[:, k:])               # step s = |di - k|
    L = np.fmin.accumulate(c[:, ::-1], axis=1)[:, ::-1]
    return e_lo, e_hi, np.ascontiguousarray(L, dtype=np.float32)


def _two_candidate(m, x, t, q, k, d):
    """The candidates of tap k + d, two-extremum form, as the kernels take
    them: sdphi2 + po * (Mmin where po >= 0, else Mmax), each rounded,
    BIG where the value read is not valid."""
    h = m.shape[0] - 2 * k
    qq = q[:, k + d, None]
    v = np.where(qq >= 0, m[k + d:k + d + h], x[k + d:k + d + h])
    return np.where(_valid(v), t[:, k + d, None] + qq * v, BIG_PARAM)


def pass2_two_centre_out(Mmin, Mmax, sdphi2, po, k: int, *, band: int = 64,
                         group: int = 8):
    """The schedule of the two-extremum form's pruned build: one warp per
    output row and ``band`` columns takes the taps centre-out in groups of
    ``group`` steps (as :func:`pass2_centre_out`), each reading the
    extremum its po's sign names, and leaves after a group once no
    column's minimum is above L[y, nj] (:func:`two_exit_bound`, nj the
    nearest step still to visit); a row whose L[y, 0] is BIG takes no tap.

    Returns ``(amin, taps)``: amin (h, w), ``pass2_min(Mmax=)``'s bit for
    bit where the extrema meet the form's precondition, and the taps each
    warp took, (h, ceil(w / band)), repeats included."""
    m, x, t, q = _two_inputs(Mmin, Mmax, sdphi2, po)
    L = two_exit_bound(m, x, t, q, k)[2]
    h, w = m.shape[0] - 2 * k, m.shape[1]
    nb = -(-w // band)
    acc = np.full((h, w), BIG_PARAM, np.float32)
    active = np.repeat((L[:, 0] < BIG_PARAM)[:, None], nb, axis=1)
    taps = np.zeros((h, nb), np.int64)

    def tap(d):
        lanes = np.repeat(active, band, axis=1)[:, :w]
        np.copyto(acc, np.fmin(acc, _two_candidate(m, x, t, q, k, d)),
                  where=lanes)
        taps[active] += 1

    for j in range(0, k + 1, group):
        if not active.any():
            break
        for d in range(j, j + group):
            tap(-min(d, k))
            tap(min(d, k))
        nj = j + group
        if nj > k:
            break
        need = np.zeros((h, nb * band), bool)
        need[:, :w] = acc > L[:, nj, None]
        active &= need.reshape(h, nb, band).any(axis=2)
    return acc, taps


def pass2_two_least_taps(Mmin, Mmax, sdphi2, po, k: int):
    """The taps the two-extremum form's exact exit needs in each output
    cell, each column on its own with no warp, group or repeat: the
    centre, then k -+ 1, ... (1 + 2j taps through step j), leaving after
    the first step j whose minimum is no larger than L[y, j+1]; none where
    L[y, 0] is BIG.  It depends on how tight L is: see
    :func:`pass2_two_floor_taps` for a count that does not.

    Returns ``(amin, taps)``: amin (h, w), as :func:`pass2_two_centre_out`,
    and the taps of each cell, (h, w)."""
    m, x, t, q = _two_inputs(Mmin, Mmax, sdphi2, po)
    L = two_exit_bound(m, x, t, q, k)[2]
    h, w = m.shape[0] - 2 * k, m.shape[1]
    acc = np.full((h, w), BIG_PARAM, np.float32)
    live = np.repeat((L[:, 0] < BIG_PARAM)[:, None], w, axis=1)
    taps = np.zeros((h, w), np.int64)
    for j in range(k + 1):
        if not live.any():
            break
        for d in ((0,) if j == 0 else (-j, j)):
            np.copyto(acc, np.fmin(acc, _two_candidate(m, x, t, q, k, d)),
                      where=live)
            taps += live
        if j == k:
            break
        live &= acc > L[:, j + 1, None]
    return acc, taps


def pass2_two_floor_taps(Mmin, Mmax, sdphi2, po, k: int, amin=None):
    """The least taps any exact centre-out exit of the two-extremum form
    takes in each output cell: the centre, then k -+ 1, ... (1 + 2j taps
    through step j), leaving after the first step whose running minimum
    equals the cell's own minimum (no tap still to come is then smaller,
    and an exact exit may not leave before); none where that minimum is
    BIG (no candidate).  The count does not depend on any bound table, so
    ``chip_smoke.py`` counts the operations of the form's bound from it.
    ``amin``: the cell minima (``pass2_min(Mmax=)``), computed if not
    given.

    Returns ``(amin, taps)``, taps (h, w)."""
    m, x, t, q = _two_inputs(Mmin, Mmax, sdphi2, po)
    h, w = m.shape[0] - 2 * k, m.shape[1]
    steps = [(0,)] + [(-j, j) for j in range(1, k + 1)]
    if amin is None:
        amin = np.full((h, w), BIG_PARAM, np.float32)
        for d in (d for ds in steps for d in ds):
            np.fmin(amin, _two_candidate(m, x, t, q, k, d), out=amin)
    acc = np.full((h, w), BIG_PARAM, np.float32)
    live = acc > amin
    taps = np.zeros((h, w), np.int64)
    for ds in steps:
        if not live.any():
            break
        for d in ds:
            np.copyto(acc, np.fmin(acc, _two_candidate(m, x, t, q, k, d)),
                      where=live)
            taps += live
        live &= acc > amin
    return amin, taps
