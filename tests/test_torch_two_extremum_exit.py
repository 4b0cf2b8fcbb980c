"""The exact early exit of kernel B2's two-extremum form, modelled on the
host, on the CPU.

Past its staged build the two-extremum form (``pass2_min_two_cuda``) runs
the pass-2 routine of ``csrc/pass2_pruned.cuh``: each tap reads one
extremum, Mmin where po >= 0 and Mmax where po < 0, and a warp leaves once
no column's minimum is above L[y, nj], the least candidate any tap still
to come could give (``tools/pruned_model.py::two_exit_bound``, built from
each padded row's least valid Mmin and greatest valid Mmax).  The card
kernels are held to the plain version in ``tests/test_torch_cuda.py``.
Here the NumPy models of that schedule (``pass2_two_centre_out``), of its
least taps (``pass2_two_least_taps``) and of the least taps of any exact
centre-out exit (``pass2_two_floor_taps``, the operations of the form's
bound in ``chip_smoke.py``, also held to a cell-by-cell count) are held
bit for bit against the port's plain ``pass2_min(Mmax=)``, and L against
every candidate of every tap, on:

* the conftest's worlds (pass 1's extrema of their coast) with the grids'
  own tables (po >= 0: there the form must exit no later than the single
  form's) and with po drawn from [-1, 1];
* po = +-0 at the centre tap (sdphi2 = +0 there), Mmax equal to Mmin,
  rows whose windows hold no coast (no taps), windows cut by a lat edge;

at k = 0, 1, 15 and 94; and at k = 15 against the JAX package's
``pass2_min_pallas(..., Mmax)`` in interpret mode (BIG structure equal,
then rtol 3e-7, ``tests/test_pallas_kernels.py:59-66``) and its plain pass
2 (bit for bit).  Inputs come from seeds with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu.ops.pallas.distance_kernel import pass2_min_pallas
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.ops import coastline as tco
from seabreeze_param_tpu_torch.ops import distance as tdist
from tools.pruned_model import (pass2_centre_out, pass2_two_centre_out,
                                pass2_two_floor_taps, pass2_two_least_taps,
                                two_exit_bound)

BIG = np.float32(1.0e30)
RADII = [0, 1, 15, 94]


def _world_inputs(c, k, po_kind):
    """Pass 1's extrema of a conftest world's coast at radius k, the
    grid's sdphi2 and its row flags, and po: the grid's or drawn from
    [-1, 1]."""
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = tco.get_edges(torch.as_tensor(c["lsm"]),
                          torch.as_tensor(c["ci_t"][0]))
    tabs = tdist.device_tables(grid, k, "cpu")
    mmin, mmax = tdist.pass1_extrema(tdist.pad_coast(coast, k), tabs[2], k,
                                     need_max=True)
    po = tabs[1].numpy()
    if po_kind == "random":
        rng = np.random.default_rng(k + 31)
        po = (2.0 * rng.random(po.shape) - 1.0).astype(np.float32)
    return (mmin.numpy(), mmax.numpy(), tabs[0].numpy(), po,
            tabs.row_monotone.numpy())


def _plain(mmin, mmax, sdphi2, po, k):
    T = torch.as_tensor
    return tdist.pass2_min(T(mmin), T(sdphi2), T(po), k,
                           Mmax=T(mmax)).numpy()


def _bits_equal(got, ref):
    """Bit for bit, signed zeros told apart."""
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _check_bound(mmin, mmax, sdphi2, po, k):
    """No candidate of a tap at step j or past it (the plain version's: the
    min of both products, then the add) is below L[y, j]; L is at most
    BIG.  Returns L."""
    L = two_exit_bound(mmin, mmax, sdphi2, po, k)[2]
    h = mmin.shape[0] - 2 * k
    assert L.shape == (h, k + 1) and (L <= BIG).all()
    assert (np.diff(L, axis=1) >= 0).all()       # a suffix minimum
    for di in range(2 * k + 1):
        lo, hi = mmin[di:di + h], mmax[di:di + h]
        q = po[:, di, None]
        cand = sdphi2[:, di, None] + np.minimum(q * lo, q * hi)
        cand = np.where(lo > BIG / 2, BIG, cand)
        assert (cand >= L[:, abs(di - k), None]).all(), di
    return L


def _check_models(mmin, mmax, sdphi2, po, k):
    """The three models bit-equal to the plain version; the least taps odd
    (the centre, then pairs) or none, never more than the warp's in the
    schedule, and never fewer than the floor's.  Returns (plain, warp
    taps, least taps)."""
    ref = _plain(mmin, mmax, sdphi2, po, k)
    amin, warp = pass2_two_centre_out(mmin, mmax, sdphi2, po, k)
    _bits_equal(amin, ref)
    amin, least = pass2_two_least_taps(mmin, mmax, sdphi2, po, k)
    _bits_equal(amin, ref)
    assert ((least % 2 == 1) | (least == 0)).all()
    assert (least <= 2 * k + 1).all()
    w = mmin.shape[1]
    assert (least <= np.repeat(warp, 64, axis=1)[:, :w]).all()
    amin, floor = pass2_two_floor_taps(mmin, mmax, sdphi2, po, k)
    _bits_equal(amin, ref)
    assert ((floor % 2 == 1) | (floor == 0)).all()
    assert (floor <= least).all()
    assert (floor[ref >= BIG] == 0).all()
    return ref, warp, least


@pytest.mark.parametrize("k", RADII)
@pytest.mark.parametrize("po_kind", ["tables", "random"])
@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_two_exit_model_on_worlds(case, po_kind, k, request):
    """The conftest's worlds: both models equal the plain two-extremum pass
    2, L bounds every candidate; with the grid's own tables (po >= 0, Mmin
    >= 0) L is never below the single form's bound (the least sdphi2 still
    to come) and no warp takes more taps than in the single form's
    schedule with the rows' flags; with po in [-1, 1] the forms differ."""
    c = request.getfixturevalue(case)
    mmin, mmax, sdphi2, po, rows = _world_inputs(c, k, po_kind)
    L = _check_bound(mmin, mmax, sdphi2, po, k)
    ref, warp, least = _check_models(mmin, mmax, sdphi2, po, k)
    assert (ref < BIG / 2).any()
    T = torch.as_tensor
    single = tdist.pass2_min(T(mmin), T(sdphi2), T(po), k).numpy()
    if po_kind == "tables":
        assert (po >= 0).all() and rows.all()
        _bits_equal(ref, single)
        steps = np.fmin(sdphi2[:, k::-1], sdphi2[:, k:])
        assert (L >= np.fmin.accumulate(steps[:, ::-1], axis=1)[:, ::-1]).all()
        _, one = pass2_centre_out(mmin, sdphi2, po, k, rows, band=64)
        assert (warp <= one).all()
    elif k:
        assert (ref < single).any() and (ref <= single).all()


def _v_rows(rng, h, k):
    """(h, 2k+1) rows that fall from either end to +0 at the centre tap."""
    left = -np.sort(-rng.random((h, k)), axis=1)
    right = np.sort(rng.random((h, k)), axis=1)
    return np.concatenate([left, np.zeros((h, 1)), right],
                          axis=1).astype(np.float32)


def _case_inputs(case, k, h=23, w=70):
    """Random extrema (Mmax >= Mmin, BIG / -BIG where a window is empty)
    and tables for one of the special cases."""
    rng = np.random.default_rng(1000 * k + len(case))
    mmin = rng.random((h + 2 * k, w)).astype(np.float32)
    mmax = np.maximum(mmin, rng.random(mmin.shape).astype(np.float32))
    empty = rng.random(mmin.shape) < 0.15
    sdphi2 = _v_rows(rng, h, k)
    po = (2.0 * rng.random((h, 2 * k + 1)) - 1.0).astype(np.float32)
    if case == "signed_zero":
        # -0 at the centre tap of the even rows (their other po >= 0, so
        # the centre's +0 wins where the window holds coast), +0 at the
        # odd rows': sdphi2 is +0 there, and the candidate +0 whichever
        # extremum is read
        po[::2] = np.abs(po[::2])
        po[:, k] = np.where(np.arange(h) % 2 == 0, np.float32(-0.0),
                            np.float32(0.0))
    elif case == "equal_extrema":
        mmin[empty] = BIG
        return mmin, mmin.copy(), sdphi2, po
    elif case == "empty_rows":
        # padded rows 0 .. 2k + 3 hold no coast, so output rows 0 .. 3 see
        # none in their windows
        empty[:2 * k + 4] = True
    elif case == "lat_edge":
        # the grid's edges: taps past them hold sdphi2 BIG and po 0, and
        # their padded rows no coast
        for y in range(min(h, k)):
            sdphi2[y, :k - y] = BIG
            po[y, :k - y] = 0.0
            sdphi2[h - 1 - y, k + y + 1:] = BIG
            po[h - 1 - y, k + y + 1:] = 0.0
        empty[:k] = empty[h + k:] = True
    mmin[empty], mmax[empty] = BIG, -BIG
    return mmin, mmax, sdphi2, po


@pytest.mark.parametrize("k", RADII)
@pytest.mark.parametrize("case", ["signed_zero", "equal_extrema",
                                  "empty_rows", "lat_edge"])
def test_two_exit_model_special_cases(case, k):
    """po = +-0 at the centre tap, Mmax equal to Mmin (BIG in empty
    windows), rows whose windows hold no coast (no taps, BIG), windows cut
    by a lat edge: both models equal the plain version bit for bit and L
    bounds every candidate."""
    mmin, mmax, sdphi2, po = _case_inputs(case, k)
    L = _check_bound(mmin, mmax, sdphi2, po, k)
    ref, warp, least = _check_models(mmin, mmax, sdphi2, po, k)
    none = L[:, 0] >= BIG
    if case == "empty_rows":
        assert none[:4].all() and not none.all()
        assert (ref[none] == BIG).all()
        assert (warp[none] == 0).all() and (least[none] == 0).all()
    if case == "signed_zero":
        assert np.signbit(po[::2, k]).all()
        assert not np.signbit(po[1::2, k]).any()
        zero = ref == 0
        assert zero[::2][mmin[k:-k or None][::2] < BIG / 2].all()
        assert not np.signbit(ref[zero]).any()


@pytest.mark.parametrize("po_kind", ["tables", "random"])
def test_two_exit_model_matches_jax_at_k15(global_case, po_kind):
    """At k = 15 on the global world, the schedule's output against the JAX
    package's Pallas kernel (interpret mode; BIG structure equal, then
    rtol 3e-7) and its plain pass 2 (bit for bit), on JAX's own pass 1."""
    k = 15
    c = global_case
    jgrid = JGrid(lon=c["lon"], lat=c["lat"])
    coast = np.array(jco.get_edges(c["lsm"], c["ci_t"][0]))
    sdphi2, po, sdlam2 = jdist.distance_tables(jgrid, k)
    cpad = jdist.pad_coast(jnp.asarray(coast), k)
    mmin, mmax = (np.asarray(m) for m in jdist.pass1_extrema(
        cpad, sdlam2, k, need_max=True))
    if po_kind == "random":
        po = (2.0 * np.random.default_rng(7).random(po.shape)
              - 1.0).astype(np.float32)
    amin, _ = pass2_two_centre_out(mmin, mmax, sdphi2, po, k)
    pallas = np.asarray(pass2_min_pallas(mmin, mmax, sdphi2, po, k,
                                         tile_rows=32, tile_cols=128,
                                         interpret=True))
    big = pallas >= BIG / 2
    np.testing.assert_array_equal(amin >= BIG / 2, big)
    assert not big.all()
    np.testing.assert_allclose(amin[~big], pallas[~big], rtol=3e-7, atol=0)
    np.testing.assert_array_equal(
        amin, np.asarray(jdist.pass2_min(mmin, mmax, sdphi2, po, k)))


def _floor_by_cell(mmin, mmax, sdphi2, po, k):
    """The floor's taps cell by cell: each cell's candidates in the
    centre-out order (the plain version's, both products), and the
    shortest run of whole steps whose minimum is the cell's own."""
    h, w = mmin.shape[0] - 2 * k, mmin.shape[1]
    order = [k] + [k + s * d for d in range(1, k + 1) for s in (-1, 1)]
    taps = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            lo, hi = mmin[y + np.array(order), x], mmax[y + np.array(order), x]
            q = po[y, order]
            cand = sdphi2[y, order] + np.minimum(q * lo, q * hi)
            cand = np.fmin(np.where(lo > BIG / 2, BIG, cand), BIG)
            best = cand.min()
            if best >= BIG:
                continue
            first = int(np.argmax(np.fmin.accumulate(cand) <= best))
            taps[y, x] = first + 1 + first % 2    # up to its step's end
    return taps


@pytest.mark.parametrize("k", [1, 6, 15])
@pytest.mark.parametrize("case", ["random", "signed_zero", "empty_rows",
                                  "lat_edge"])
def test_two_floor_taps_by_cell(case, k):
    """The floor's taps equal a count made cell by cell from the plain
    version's candidates, and stop no later than the exit on L: the floor
    depends on the data alone, not on how tight a bound table is."""
    mmin, mmax, sdphi2, po = _case_inputs(case, k, h=9, w=21)
    amin, floor = pass2_two_floor_taps(mmin, mmax, sdphi2, po, k)
    _bits_equal(amin, _plain(mmin, mmax, sdphi2, po, k))
    np.testing.assert_array_equal(floor,
                                  _floor_by_cell(mmin, mmax, sdphi2, po, k))
    least = pass2_two_least_taps(mmin, mmax, sdphi2, po, k)[1]
    assert (floor <= least).all()
    if case == "random":
        assert (floor < least).any()
