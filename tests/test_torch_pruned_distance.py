"""The row flags behind the wide-radius builds' early exit in pass 2, and a
NumPy model of that exit, on the CPU.

On the card kernel B2's unstaged build (k > 175) and kernel B3's large
build (k > 354) run pass 2 through ``csrc/pass2_pruned.cuh``: one warp per
output row and band of 32 columns visits the taps centre-out and leaves
once no column's minimum is above the least sdphi2 still to come, on the
rows of sdphi2 that ``device_tables`` flags (``row_monotone``).
``tests/test_torch_cuda.py`` holds both builds bit-equal to their plain
versions there.  Here, on a 48 x 256 world 0.0036 degrees apart from 54 N
(a 0.4 km grid, k = 387):

* ``device_tables`` flags every sdphi2 row of a regional and a global grid;
* ``DistanceTables.select`` carries the row flags by rows;
* ``tools/pruned_model.py::pass2_centre_out``, the model of the kernels'
  schedule, gives exactly ``pass2_min``'s output with fewer taps than 2k+1
  per warp, and the JAX package's pass 2 within its own tests' tolerance
  (BIG structure equal, then rtol 3e-7: XLA may contract the multiply and
  the add);
* ``tools/pruned_model.py::pass2_least_taps``, the least taps of an exact
  exit column by column (the operations of these builds' bound in
  ``chip_smoke.py``), gives ``pass2_min``'s output too, with no cell
  taking more taps than its warp in the kernels' schedule.

``tests/test_torch_fused_distance.py::test_distances_match_jax_xla_at_k387``
holds the port's fused and hybrid distances at this radius against JAX.
"""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.ops import coastline as tco
from seabreeze_param_tpu_torch.ops import distance as tdist
from tools.pruned_model import pass2_centre_out, pass2_least_taps

BIG = np.float32(1.0e30)
NLAT, NLON, SPACING, K = 48, 256, 0.0036, 387


def _grid(kind):
    """The 0.4 km regional grid from 54 N, or a global grid of as many
    cells (a lat axis from pole to pole, so its edge rows are the poles)."""
    if kind == "regional":
        lat = 54.0 - np.arange(NLAT) * SPACING
        lon = np.arange(NLON) * SPACING
    else:
        lat = np.linspace(90.0, -90.0, NLAT)
        lon = np.arange(NLON) * (360.0 / NLON)
    return Grid(lon=lon.astype(np.float32), lat=lat.astype(np.float32))


def _wide_inputs():
    """Mmin (pass 1 of the world's coast), sdphi2, po and the row flags on
    the 0.4 km grid at k = 387, the radius of 180 km there (a field this
    small caps ``effective_radius`` at its width; the kernels take any
    k)."""
    grid = _grid("regional")
    k = K
    assert grid.search_radius_cells(180.0) == k
    lsm, *_, ci = make_world(NLAT, NLON, 1, 1, seed=3)
    tabs = tdist.device_tables(grid, k, "cpu")
    coast = tco.get_edges(torch.as_tensor(lsm), torch.as_tensor(ci[0]))
    assert 0 < int(coast.sum()) < coast.numel()
    mmin, _ = tdist.pass1_extrema(tdist.pad_coast(coast, k), tabs[2], k)
    return mmin, tabs, k


@pytest.mark.parametrize("kind", ["regional", "global"])
def test_device_tables_flag_every_sdphi2_row(kind):
    """A grid with monotone latitudes has the property in every sdphi2
    row, the rows whose window leaves the grid (BIG taps) included."""
    grid = _grid(kind)
    tabs = tdist.device_tables(grid, K, "cpu")
    sdphi2 = tabs[0].numpy()
    flags = tabs.row_monotone
    assert flags.dtype == torch.uint8 and flags.shape == (NLAT,)
    np.testing.assert_array_equal(
        flags.numpy(), tdist.window_monotone(sdphi2, K).astype(np.uint8))
    assert bool(flags.all())
    assert (sdphi2 == BIG).any(axis=1).all()     # every row meets an edge


def test_select_carries_row_flags():
    """``select`` picks the rows' flags by ``rows`` (slices and index
    tensors, as the decomposed run's blocks take them) and the columns'
    by ``cols``."""
    tabs = tdist.device_tables(_grid("regional"), 5, "cpu")
    flags = tabs.row_monotone.clone()
    flags[7] = 0                                 # tell the rows apart
    tabs.row_monotone = flags
    ridx, cidx = torch.tensor([7, 7, 0, 47]), torch.tensor([255, 0, 3])
    for rows, cols in ((slice(3, 20), slice(10, 40)), (ridx, cidx)):
        sub = tabs.select(rows, cols)
        assert torch.equal(sub.row_monotone, flags[rows])
        assert torch.equal(sub.monotone, tabs.monotone[cols])
        assert torch.equal(sub[0], tabs[0][rows])


@pytest.mark.parametrize("band,group", [(32, 4), (64, 4), (64, 8)])
@pytest.mark.parametrize("skip_empty", [False, True])
def test_centre_out_model_matches_pass2_min(band, group, skip_empty):
    """The model of the kernels' pass 2 gives ``pass2_min``'s output bit
    for bit, with fewer taps than 2k+1 in every warp where the rows are
    flagged, and every group of taps (2k+1 and the repeats that fill the
    groups) in every warp without the flags."""
    mmin, tabs, k = _wide_inputs()
    sdphi2, po, _ = tabs
    ref = tdist.pass2_min(mmin, sdphi2, po, k).numpy()
    assert (ref < BIG / 2).all()                 # every cell has coast in reach
    amin, taps = pass2_centre_out(mmin, sdphi2, po, k,
                                  tabs.row_monotone.numpy(), band=band,
                                  group=group, skip_empty=skip_empty)
    np.testing.assert_array_equal(amin, ref)
    assert taps.shape == (NLAT, NLON // band)
    assert taps.max() < 2 * k + 1 and taps.min() >= 1
    amin, every = pass2_centre_out(mmin, sdphi2, po, k, None, band=band,
                                   group=group, skip_empty=skip_empty)
    np.testing.assert_array_equal(amin, ref)
    groups = -(-(k + 1) // group)
    assert (every == 2 * group * groups).all()
    assert 2 * group * groups >= 2 * k + 1


def test_centre_out_model_skips_empty_windows():
    """A field whose coast lies more than 2k rows below the first rows: with
    ``skip_empty`` (kernel B3's row flags) their warps take no tap and
    write BIG, without it they take every tap; the output is
    ``pass2_min``'s either way."""
    k, h, w = 6, 30, 40
    rng = np.random.default_rng(1)
    m = np.full((h + 2 * k, w), BIG, np.float32)
    m[k + h - 3:k + h] = rng.random((3, w), np.float32)  # the last 3 rows
    lat = np.linspace(60.0, 50.0, h).astype(np.float32)
    tabs = tdist.device_tables(
        Grid(lon=np.arange(w, dtype=np.float32), lat=lat), k, "cpu")
    ref = tdist.pass2_min(torch.as_tensor(m), tabs[0], tabs[1], k).numpy()
    empty = (ref == BIG).all(axis=1)
    assert empty.any() and not empty.all()
    for skip in (False, True):
        amin, taps = pass2_centre_out(m, tabs[0], tabs[1], k,
                                      tabs.row_monotone.numpy(),
                                      skip_empty=skip)
        np.testing.assert_array_equal(amin, ref)
        assert (taps[empty] == (0 if skip else 16 * -(-(k + 1) // 8))).all()


def test_centre_out_model_matches_jax_pass2():
    """The model against the JAX package's pass 2 (single-extremum form) on
    the same inputs: BIG structure equal, then rtol 3e-7."""
    mmin, tabs, k = _wide_inputs()
    sdphi2, po, _ = tabs
    amin, _ = pass2_centre_out(mmin, sdphi2, po, k,
                               tabs.row_monotone.numpy())
    ref = np.asarray(jdist.pass2_min(mmin.numpy(), None, sdphi2.numpy(),
                                     po.numpy(), k))
    big = ref >= BIG / 2
    np.testing.assert_array_equal(amin >= BIG / 2, big)
    np.testing.assert_allclose(amin[~big], ref[~big], rtol=3e-7, atol=0)


@pytest.mark.parametrize("band,group", [(32, 8), (64, 8)])
def test_least_taps_match_pass2_min(band, group):
    """The least taps of an exact exit, column by column, give
    ``pass2_min``'s output bit for bit; no cell takes more taps than its
    warp in the kernels' schedule, and every cell takes 2k+1 without the
    flags."""
    mmin, tabs, k = _wide_inputs()
    sdphi2, po, _ = tabs
    ref = tdist.pass2_min(mmin, sdphi2, po, k).numpy()
    flags = tabs.row_monotone.numpy()
    amin, least = pass2_least_taps(mmin, sdphi2, po, k, flags)
    np.testing.assert_array_equal(amin, ref)
    assert least.shape == (NLAT, NLON) and least.min() >= 1
    assert (least % 2 == 1).all()                # the centre, then pairs
    _, warp = pass2_centre_out(mmin, sdphi2, po, k, flags, band=band,
                               group=group)
    assert (least <= np.repeat(warp, band, axis=1)).all()
    assert least.mean() < warp.mean()
    amin, every = pass2_least_taps(mmin, sdphi2, po, k, None)
    np.testing.assert_array_equal(amin, ref)
    assert (every == 2 * k + 1).all()


def test_least_taps_skip_empty_windows():
    """With ``skip_empty`` the rows whose window holds no coast take no
    tap and keep BIG; the output is ``pass2_min``'s either way."""
    k, h, w = 6, 30, 40
    rng = np.random.default_rng(1)
    m = np.full((h + 2 * k, w), BIG, np.float32)
    m[k + h - 3:k + h] = rng.random((3, w), np.float32)  # the last 3 rows
    lat = np.linspace(60.0, 50.0, h).astype(np.float32)
    tabs = tdist.device_tables(
        Grid(lon=np.arange(w, dtype=np.float32), lat=lat), k, "cpu")
    ref = tdist.pass2_min(torch.as_tensor(m), tabs[0], tabs[1], k).numpy()
    empty = (ref == BIG).all(axis=1)
    for skip in (False, True):
        amin, taps = pass2_least_taps(m, tabs[0], tabs[1], k,
                                      tabs.row_monotone.numpy(),
                                      skip_empty=skip)
        np.testing.assert_array_equal(amin, ref)
        assert (taps[empty] == (0 if skip else 2 * k + 1)).all()
        assert (taps[~empty] >= 1).all()
