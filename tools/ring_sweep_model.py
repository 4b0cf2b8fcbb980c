"""NumPy model of the ring kernels' sweep build (kernels B1, B4 and B5 at
ring radii NN past 2047, ``seabreeze_param_tpu_torch/csrc/ring_trigger.cu``,
the ``sweep_*`` kernels), on the host.

The sweep build runs every running-sum chain of the ring search once per
field, spread over the whole card, where the tile builds run the chains
each tile reads in that tile's block.  Every hp element (a row of the
padded field at one field column) and every vc element (a column of the
padded field at one field row) is its own chain of additions, in the order
of ``ops/ring_search.py``, so its value at order k does not depend on when
the chain runs.  The launch:

1. ``sweep_latch``: each cell that runs finds its latch radius rc and land
   count (box counts of the integral image of land, exact to 2047, then
   the plain version's float32 chain), and the launch's largest rc per
   field column (``Rcol``), per field row (``Rrow``) and overall (``R``),
   which 2 and 3 read: they take the elements a window reads up to R only,
   and the bands end at R (none where R is 0);
2. ``sweep_catchup``: every element a window will read runs from order 0
   to the order before the first one a window reads, in parallel
   (hp: a warp per padded row and 32 x ``hc`` columns, ``hc`` columns a
   lane, the row's cells in a ring in the warp's shared memory; vc: a
   block of ``nw`` warps per 32 padded columns and nw x ``vr`` field rows,
   ``vr`` rows a lane, the columns' cells in a ring of rows in the block's
   shared memory); the longest chains first;
3. ``sweep_bands``, one cooperative launch with a grid barrier between
   bands; in each band of ``band`` radii [n0, n1] the elements
   a window reads in the band advance through it and write the values the
   windows read into a band buffer indexed by cell, (direction, radius,
   row, column); in the same band each cell's window takes the band
   before's four values a radius, up to its latch, from the other buffer;
4. ``sweep_final``: n_thc from the latched sums, then the trigger tail.

:func:`sweep_thc` runs that schedule lane by lane, with the kernels' own
index arithmetic (the warp's staged cells and each lane's register
windows), and returns n_thc, which equals ``ring_thc_from_padded``'s bit
for bit; it checks as it goes that every window reads a value written in
its own band and every element is advanced by one lane a launch.
:func:`chain_floor` counts the least additions a bit-equal schedule needs
for given latch radii, which ``chip_smoke.py`` prints beside the bound.

Used by ``tests/test_torch_ring_schedule.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np

WARP = 32
#: hp columns a lane and vc rows a lane (HC and VR in ring_trigger.cu).
HC, VR = 4, 8
#: The widest radius whose window's cell count is exact in float32.
EXACT_NN = 2047
#: Bytes the launcher allows the two band buffers before it halves the
#: band (SWEEP_BAND_BYTES), and the widest and narrowest band.
BAND_BYTES, BAND_MAX, BAND_MIN = 128 << 20, 64, 8
#: The kernel's tile (ever-coastal mask of B1).
TILE = (16, 32)


def sweep_band(h: int, w: int) -> int:
    """The band of radii the launcher takes over an (h, w) field: the widest
    of 64, 32, 16, 8 whose two buffers of 4 float2 a cell and radius (rows
    of w rounded up to 4) fit :data:`BAND_BYTES` (else 8)."""
    band, wb = BAND_MAX, -(-w // 4) * 4
    while band > BAND_MIN and 2 * 4 * band * h * wb * 8 > BAND_BYTES:
        band //= 2
    return band


def quantities(t0_pad, cd_pad):
    """(ph, pw, 2) float32: (t0*land, t0 - t0*land), as the kernels form
    each cell (``strip_q``)."""
    t0 = np.asarray(t0_pad, np.float32)
    land = (np.asarray(cd_pad, np.float32) >= 0).astype(np.float32)
    tl = t0 * land
    return np.stack([tl, t0 - tl], axis=-1)


def _cells(q, rows, cols):
    """q at (rows, cols), broadcast; (0, 0) outside the padded field (the
    kernels' loads take t0 0 and the land sentinel there)."""
    ph, pw = q.shape[:2]
    rows, cols = np.broadcast_arrays(np.asarray(rows), np.asarray(cols))
    ok = (rows >= 0) & (rows < ph) & (cols >= 0) & (cols < pw)
    out = np.zeros(rows.shape + (2,), np.float32)
    out[ok] = q[rows[ok], cols[ok]]
    return out


def latch(cd_pad, cd, nn: int, run):
    """(rc, n_land): each running cell's latch radius (the first nn whose
    window holds both classes, else NN) and land count there, 0 elsewhere;
    exact box counts up to :data:`EXACT_NN`, past it the plain version's
    float32 running count (``sweep_latch``)."""
    land = (np.asarray(cd_pad) >= 0).astype(np.int64)
    h, w = np.asarray(cd).shape
    ii = np.zeros((land.shape[0] + 1, land.shape[1] + 1), np.int64)
    ii[1:, 1:] = land.cumsum(0).cumsum(1)

    def box(y0, x0, y1, x1):
        a, b, c, d = nn + y0, nn + y1 + 1, nn + x0, nn + x1 + 1
        return (ii[b:b + h, d:d + w] - ii[a:a + h, d:d + w]
                - ii[b:b + h, c:c + w] + ii[a:a + h, c:c + w])

    rc = np.where(run, nn, 0).astype(np.int64)
    n_l = np.zeros((h, w), np.float32)
    done = ~run
    n_f = None
    for m in range(1, nn + 1):
        if m <= EXACT_NN:
            cnt = box(-m, -m, m, m)
            ok = (cnt > 0) & (cnt < (2 * m + 1) ** 2)
            cur = cnt.astype(np.float32)
            if m == EXACT_NN:
                n_f = cur
        else:
            for part in (box(-m, -m, -m, m), box(m, -m, m, m),
                         box(1 - m, -m, m - 1, -m), box(1 - m, m, m - 1, m)):
                n_f = n_f + part.astype(np.float32)
            cur = n_f
            ok = (n_f > 0) & (np.float32((2 * m + 1) ** 2) - n_f > 0)
        last = (ok | (m == nn)) & ~done
        rc = np.where(last, m, rc)
        n_l = np.where(last, cur, n_l)
        done |= ok
    return rc, n_l


# --- which elements a window reads -----------------------------------------
# hp element (e, x): padded row NN + e, field column x; the window of cell
# (y, x) reads it at radius k = y - e (top) or e - y (bottom).  vc element
# (y, e'): field row y, padded column NN + e'; cell (y, x) reads its order
# nn - 1 at radius nn = x - e' (left) or e' - x (right).

def first_radius(e, n):
    """The least radius at which a window of an n-long field axis reads the
    element at offset e (hp: n = h; vc: n = w)."""
    e = np.asarray(e)
    return np.where(e < 0, -e, np.where(e >= n, e - n + 1, 1))


def last_radius(e, n, nn):
    """The greatest radius at which one does (0: none), at most NN."""
    e = np.asarray(e)
    return np.minimum(np.maximum(n - 1 - e, e), nn)


def hp_warps(h, nn, ncg, n0=None, n1=None):
    """The hp warps of a launch, in launch order: (e, column group).  The
    catch-up (``n0`` None) takes every padded row, the rows whose first
    radius is largest first; a band [n0, n1] the rows it reads: offsets d
    from the field's edge with d <= n1 and h - 1 + d >= n0 on each side,
    and the field's own rows while n0 <= h - 1."""
    if n0 is None:
        dlo, dhi, mid = 1, nn, True
    else:
        dlo, dhi, mid = max(1, n0 - h + 1), min(n1, nn), n0 <= h - 1
    out = []
    for d in range(dhi, dlo - 1, -1):
        out += [(-d, g) for g in range(ncg)] + [(h - 1 + d, g)
                                                for g in range(ncg)]
    if mid:
        out += [(e, g) for e in range(h) for g in range(ncg)]
    return out


def vc_blocks(w, nn, nyb, n0=None, n1=None):
    """The vc blocks of a launch: (row block, first offset, step): lanes
    e' = first + step * lane.  Left of the field e' = -(d0 + lane), right
    e' = w - 1 + d0 + lane (d0 = 1, 33, ...), then the field's own columns
    (step 1 from 0, 32, ...); a band takes the groups it reads."""
    groups = []
    for d0 in range(1 + (nn - 1) // WARP * WARP, 0, -WARP):
        if n0 is None or (d0 <= n1 and d0 + WARP - 1 >= n0 - w + 1):
            groups += [(-d0, -1), (w - 1 + d0, 1)]
    if n0 is None or n0 <= w - 1:
        groups += [(m0, 1) for m0 in range(0, w, WARP)]
    return [(yb, f, s) for f, s in groups for yb in range(nyb)]


class _Trace:
    """What the model checks and counts: the stamp (band) of each band
    buffer slot, the element updates (add2 steps) a phase takes, and which
    lane advanced each element in a launch."""

    def __init__(self, h, w, band):
        self.stamp = np.full((2, 4, band, h, w), -1, np.int64)
        self.updates = {"catchup": 0, "sweep": 0, "window": 0}
        self.lane_updates = {"catchup": 0, "sweep": 0}
        self.owner = None

    def own(self, key):
        if key in self.owner:
            raise AssertionError(f"element {key} advanced by two lanes in "
                                 "one launch")
        self.owner.add(key)


def _hp_run(q, r, cw, so, t, hc, v, emit, chunk=WARP):
    """One warp's hp chains: lane l's ``hc`` elements at padded columns cw
    + l*hc + i of padded row r, from order so (``v``, (32, hc, 2)) to order
    t, calling ``emit(k, v)`` at each order past so.  Each lane keeps the
    cells of its elements' left and right terms in two register windows of
    ``hc`` slots (the left window holds positions cb + m - k, the right cb
    + m + k, cb = cw + l*hc; position m sits in slot (m -/+ (k - so)) mod
    hc).  A chunk of ``chunk`` orders (one a lane, a multiple of hc) reads
    (32 - 1) * hc + chunk cells a side, kept in a ring of cells a side by
    position modulo the ring's size (the least power of two holding a
    chunk's cells and the next chunk's new ones: 256 at hc = 4, HRING in
    the kernel) in the warp's shared memory: the first
    chunk stages them all, each later one the ``chunk`` new ones; a cell
    overwritten before its last read would show as a wrong value."""
    assert chunk == WARP and chunk % hc == 0
    lanes = np.arange(WARP)
    cb = cw + lanes * hc
    m = np.arange(hc)
    lw = _cells(q, r, cb[:, None] + m[None] - so)     # slot m: position m
    rw = _cells(q, r, cb[:, None] + m[None] + so)
    span = (WARP - 1) * hc + chunk
    ring = 1 << (span + chunk - 1).bit_length()
    ring_l = np.full((ring, 2), np.nan, np.float32)
    ring_r = np.full((ring, 2), np.nan, np.float32)
    steps = 0
    for kc in range(so + 1, t + 1, chunk):
        l0, r0 = cw - kc - chunk + 1, cw + hc - 1 + kc
        new_l = new_r = np.arange(span)
        if kc == so + 1:
            ring_l[(l0 + new_l) % ring] = _cells(q, r, l0 + new_l)
            ring_r[(r0 + new_r) % ring] = _cells(q, r, r0 + new_r)
        if kc + chunk <= t:
            # the next chunk's new cells: the kernel loads them during this
            # chunk and stores them after it; stored here first, they show
            # any slot this chunk still reads
            nl, nr = l0 - chunk + np.arange(chunk), r0 + span + np.arange(
                chunk)
            ring_l[nl % ring] = _cells(q, r, nl)
            ring_r[nr % ring] = _cells(q, r, nr)
        lb, rb = l0 + lanes * hc + chunk - 1, r0 + lanes * hc
        for s in range(chunk):
            k = kc + s
            if k > t:
                break
            lw[:, hc - 1 - s % hc] = ring_l[(lb - s) % ring]
            rw[:, s % hc] = ring_r[(rb + s) % ring]
            for i in range(hc):
                v[:, i] = ((v[:, i] + lw[:, (i + hc - 1 - s) % hc])
                           + rw[:, (i + 1 + s) % hc])
            steps += 1
            emit(k, v)
    return steps


def _vc_run_block(q, rb, pc, so, t_order, vr, nw, u, emit, chunk=16):
    """One vc block's chains: warp w's lane l holds the ``vr`` elements at
    padded rows rb + w*vr + i of padded column pc[l], from order so (``u``,
    (nw, 32, vr, 2)) to order t_order, calling ``emit(j, u)`` at each order
    past so; up and down register windows as :func:`_hp_run`'s.  A chunk of
    ``chunk`` orders (a multiple of vr) reads chunk + (nw - 1) * vr padded
    rows a side of the block's 32 columns, kept in the block's rings of
    rows (by row modulo the ring's size, VRING = 64 in the kernel): the
    first chunk stages them all, each later chunk's ``chunk`` new rows are
    loaded during the chunk before (stored here first, as in
    :func:`_hp_run`)."""
    assert chunk % vr == 0
    span = chunk + (nw - 1) * vr
    ring = 1 << (span + chunk - 1).bit_length()
    m = np.arange(vr)
    r0 = rb + np.arange(nw)[:, None, None] * vr + m       # (nw, 1, vr)
    upw = _cells(q, r0 - so, pc[None, :, None])           # (nw, 32, vr, 2)
    dnw = _cells(q, r0 + so, pc[None, :, None])
    ring_u = np.full((ring, WARP, 2), np.nan, np.float32)
    ring_d = np.full((ring, WARP, 2), np.nan, np.float32)
    wv = np.arange(nw)[:, None] * vr
    steps = 0
    for jc in range(so + 1, t_order + 1, chunk):
        u0, d0 = rb - jc - (chunk - 1), rb + vr - 1 + jc
        rows = np.arange(span)
        if jc == so + 1:
            ring_u[(u0 + rows) % ring] = _cells(q, (u0 + rows)[:, None], pc)
            ring_d[(d0 + rows) % ring] = _cells(q, (d0 + rows)[:, None], pc)
        if jc + chunk <= t_order:
            nu, nd = u0 - chunk + np.arange(chunk), d0 + span + np.arange(
                chunk)
            ring_u[nu % ring] = _cells(q, nu[:, None], pc)
            ring_d[nd % ring] = _cells(q, nd[:, None], pc)
        for s in range(chunk):
            j = jc + s
            if j > t_order:
                break
            upw[:, :, vr - 1 - s % vr] = ring_u[(u0 + wv + chunk - 1 - s)
                                                % ring, np.arange(WARP)]
            dnw[:, :, s % vr] = ring_d[(d0 + wv + s) % ring,
                                       np.arange(WARP)]
            for i in range(vr):
                u[:, :, i] = ((u[:, :, i] + upw[:, :, (i + vr - 1 - s) % vr])
                              + dnw[:, :, (i + 1 + s) % vr])
            steps += 1
            emit(j, u)
    return steps


def sweep_thc(t0_pad, cd_pad, cd, nn: int, maxdist: float, *, run=None,
              band=None, hc=HC, vr=VR, nw=4, stats=None):
    """n_thc (h, w) of the sweep build's schedule: the cells in ``run``
    (default all; B1's ever-coastal tiles) within maxdist take the ring
    search, the rest 0.  ``band``: radii a band (default
    :func:`sweep_band`); ``hc``/``vr``: hp columns and vc rows a lane;
    ``nw``: warps a vc block (chunks of 16 orders).
    ``stats`` (a dict) receives the element updates of valid elements by
    phase (``catchup``, ``sweep``: the bands' chains, ``window``: cell
    radii), those of every lane (``lane_updates``), the band, the number
    of bands and the widest latch radius ``R``."""
    cd = np.asarray(cd, np.float32)
    h, w = cd.shape
    NN = int(nn)
    band = sweep_band(h, w) if band is None else int(band)
    q = quantities(t0_pad, cd_pad)
    run = np.ones((h, w), bool) if run is None else np.asarray(run, bool)
    coastal = run & (np.abs(cd) <= np.float32(maxdist))
    rc, n_land = latch(cd_pad, cd, NN, coastal)
    Rcol, Rrow, R = rc.max(axis=0), rc.max(axis=1), int(rc.max())
    W = q[NN:NN + h, NN:NN + w].copy()
    hps = np.full((h + 2 * NN, w, 2), np.nan, np.float32)
    vcs = np.full((h, w + 2 * NN, 2), np.nan, np.float32)
    bufs = np.full((2, 4, band, h, w, 2), np.nan, np.float32)
    tr = _Trace(h, w, band)
    ncg = -(-w // (WARP * hc))

    def hp_group(e, g):
        """(columns (32, hc), valid, first, last radius read) of warp
        (e, g)."""
        x = g * WARP * hc + np.arange(WARP)[:, None] * hc + np.arange(hc)
        ok = x < w
        gR = int(Rcol[x[ok]].max())
        return (x, ok, int(first_radius(e, h)),
                min(int(last_radius(e, h, NN)), gR))

    def vc_group(yb, f0, step, nw):
        """(rows (nw, vr), row ok, e' (32,), lane ok, first radius, last
        radius) of vc block (yb, f0, step) of nw warps."""
        y = yb * nw * vr + np.arange(nw * vr).reshape(nw, vr)
        yok = y < h
        ep = f0 + step * np.arange(WARP)
        # the group's side: left of the field, right of it, or in it
        lo, hi = (-NN, -1) if f0 < 0 else (w, w + NN - 1) if f0 >= w else (
            0, w - 1)
        eok = (ep >= lo) & (ep <= hi)
        gR = int(Rrow[y[yok]].max())
        nmin = int(first_radius(ep[eok], w).min())
        nmax = int(np.minimum(last_radius(ep[eok], w, NN), gR).max())
        return y, yok, ep, eok, nmin, nmax

    # the catch-up and the bands stop at R
    nb = -(-R // band)
    # 2. catch-up: each element to the order before its warp's first read
    tr.owner = set()
    for e, g in hp_warps(h, R, ncg) if nb else ():
        x, ok, kmin, kmax = hp_group(e, g)
        if kmin > kmax:
            continue
        r = NN + e
        v = _cells(q, r, NN + x)
        n = _hp_run(q, r, NN + g * WARP * hc, 0, kmin - 1, hc, v,
                    lambda k, v: None)
        tr.updates["catchup"] += n * int(ok.sum())
        tr.lane_updates["catchup"] += n * WARP * hc
        for xx in x[ok]:
            tr.own(("hp", e, int(xx)))
        hps[r, x[ok]] = v[ok]
    def vc_store(y, yok, ep, eok, pc, u):
        for wi in range(y.shape[0]):
            for a in np.flatnonzero(eok):
                for b in np.flatnonzero(yok[wi]):
                    tr.own(("vc", int(y[wi, b]), int(ep[a])))
                    vcs[y[wi, b], pc[a]] = u[wi, a, b]

    for yb, f0, step in vc_blocks(w, R, -(-h // (nw * vr))) if nb else ():
        y, yok, ep, eok, nmin, nmax = vc_group(yb, f0, step, nw)
        if nmin > nmax:
            continue
        pc = NN + ep
        u = _cells(q, NN + y[:, None, :], pc[None, :, None])
        so = max(nmin - 2, 0)
        n = _vc_run_block(q, NN + yb * nw * vr, pc, 0, so, vr, nw, u,
                          lambda j, u: None)
        tr.updates["catchup"] += n * int(eok.sum()) * int(yok.sum())
        tr.lane_updates["catchup"] += n * WARP * nw * vr
        vc_store(y, yok, ep, eok, pc, u)

    # 3. the bands: launch b advances the elements of band b into buffer
    # b % 2, then (in the same launch, read from the other buffer) the
    # windows of band b - 1
    for b in range(nb + 1 if nb else 0):
        tr.owner = set()
        n0, n1 = 1 + b * band, min((b + 1) * band, R)
        if b < nb:
            buf = b % 2
            for e, g in hp_warps(h, R, ncg, n0, n1):
                x, ok, kmin, kmax = hp_group(e, g)
                f, t = max(kmin, n0), min(kmax, n1)
                if f > t:
                    continue
                r = NN + e
                v = hps[r, np.minimum(x, w - 1)].copy()
                v[~ok] = 0.0

                def emit(k, v, e=e, x=x, ok=ok, n0=n0, buf=buf):
                    for d, yy in ((0, e + k), (1, e - k)):
                        if 0 <= yy < h:
                            bufs[buf, d, k - n0, yy, x[ok]] = v[ok]
                            tr.stamp[buf, d, k - n0, yy, x[ok]] = n0
                n = _hp_run(q, r, NN + g * WARP * hc, f - 1, t, hc, v, emit)
                tr.updates["sweep"] += n * int(ok.sum())
                tr.lane_updates["sweep"] += n * WARP * hc
                for xx in x[ok]:
                    tr.own(("hp", e, int(xx)))
                hps[r, x[ok]] = v[ok]
            for yb, f0, step in vc_blocks(w, R, -(-h // (nw * vr)), n0,
                                          n1):
                y, yok, ep, eok, nmin, nmax = vc_group(yb, f0, step, nw)
                f, t = max(nmin, n0), min(nmax, n1)
                if f > t:
                    continue
                pc = NN + ep
                so = max(nmin - 2, 0) if f == nmin else n0 - 2
                u = vcs[np.minimum(y, h - 1)[:, None, :],
                        np.clip(pc, 0, w + 2 * NN - 1)[None, :, None]].copy()
                u[~(eok[None, :, None] & yok[:, None, :])] = 0.0

                def emit(j, u, ep=ep, eok=eok, y=y, yok=yok, n0=n0, buf=buf):
                    nn_ = j + 1
                    for d, xx in ((2, ep + nn_), (3, ep - nn_)):
                        for a in np.flatnonzero(eok & (xx >= 0) & (xx < w)):
                            yy = y[yok]
                            bufs[buf, d, nn_ - n0, yy, xx[a]] = u[:, a][yok]
                            tr.stamp[buf, d, nn_ - n0, yy, xx[a]] = n0
                if f - 1 == so:
                    emit(so, u)
                n = _vc_run_block(q, NN + yb * nw * vr, pc, so, t - 1, vr,
                                  nw, u, emit)
                tr.updates["sweep"] += n * int(eok.sum()) * int(yok.sum())
                tr.lane_updates["sweep"] += n * WARP * nw * vr
                vc_store(y, yok, ep, eok, pc, u)
        if b == 0:
            continue
        # the windows of band b - 1
        p0, p1 = 1 + (b - 1) * band, min(b * band, NN)
        buf = (b - 1) % 2
        for k in range(p0, p1 + 1):
            act = rc >= k
            if not act.any():
                break
            if not (tr.stamp[buf, :, k - p0][:, act] == p0).all():
                raise AssertionError(f"radius {k}: a window reads a value "
                                     "not written in its band")
            top, bot, lft, rgt = (bufs[buf, d, k - p0] for d in range(4))
            new = (((W + top) + bot) + lft) + rgt
            W = np.where(act[..., None], new, W)
            tr.updates["window"] += int(act.sum())

    # 4. n_thc from the latched sums
    lat_ns = (np.float32(1.0) * ((2 * rc + 1) ** 2).astype(np.float32)
              - n_land)
    mul = np.where(cd >= 0, np.float32(1.0), np.float32(-1.0))
    thc = mul * (W[..., 0] / np.maximum(n_land, np.float32(1.0))
                 - W[..., 1] / np.maximum(lat_ns, np.float32(1.0)))
    if stats is not None:
        stats.update(tr.updates, lane_updates=dict(tr.lane_updates),
                     band=band, bands=nb, R=R)
    return np.where(coastal, thc, np.float32(0.0)).astype(np.float32)


def chain_floor(rc, nn: int):
    """The least work of a bit-equal schedule for latch radii ``rc`` (h, w;
    0 where a cell does not run): each hp element taken to the greatest
    order a window reads (``hp``, element updates), each vc element
    likewise (``vc``), each cell's window to its latch (``window``), and
    the float32 land count past :data:`EXACT_NN` radius by radius
    (``land``, cell-radii); ``adds``: float32 additions, 4 an element
    update (two channels, two terms), 8 a window step, 4 a land step."""
    rc = np.asarray(rc, np.int64)
    h, w = rc.shape
    NN = int(nn)
    e = np.arange(-NN, h + NN)
    hp_need = np.zeros((e.size, w), np.int64)
    for y in range(h):
        d = np.abs(y - e)[:, None]
        ok = (d >= 1) & (rc[y][None, :] >= d)
        hp_need = np.maximum(hp_need, np.where(ok, d, 0))
    ep = np.arange(-NN, w + NN)
    vc_need = np.zeros((h, ep.size), np.int64)
    for x in range(w):
        d = np.abs(x - ep)[None, :]
        ok = (d >= 1) & (rc[:, x][:, None] >= d)
        vc_need = np.maximum(vc_need, np.where(ok, d - 1, 0))
    hp, vc = int(hp_need.sum()), int(vc_need.sum())
    window = int(rc.sum())
    land = int(np.maximum(rc - EXACT_NN, 0).sum())
    return dict(hp=hp, vc=vc, window=window, land=land,
                adds=4 * (hp + vc) + 8 * window + 4 * land)
