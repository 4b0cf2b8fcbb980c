"""The port's fused coast distance (kernel B3's route) at a kilometre-scale
radius, and the host check behind B3's shortcuts, on the CPU.

On the card kernel B3 (``csrc/min_haversine.cu``) takes every radius up to
``min_haversine_limits()``; ``tests/test_torch_cuda.py`` holds it bit-equal
to its plain version there.  On the CPU its wrapper takes the plain version,
so the first test pins what the kernel is held to at the radius of a
convection-permitting grid: the port's ``coast_distance(impl='fused')`` on
an 80 x 96 world at 0.015 degrees from 58 N (k = 95) against the JAX
package's fused Pallas kernel in interpret mode.  Tolerances: the sign and
the 12000 km sentinel equal, then rtol 2e-5 / atol 2e-3 km (the two take
the transcendentals of the winner through different libraries).

The second holds the port's fused and hybrid distances (the routes of
B3 and B2) against the JAX package's plain one at k = 387, the radius of a
0.4 km grid, past what both kernels once held on the card.

The others pin ``ops.distance.window_monotone`` (per row of a table: no
increase from either end of the window to its centre tap), whose flags
``device_tables`` hands to B3: against a loop over every tap on the card
tests' four grids, on a regional grid's seam, and on tables without the
property; and ``DistanceTables.select``, which carries the flags into a
decomposed run's blocks.
"""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.ops import coastline as tco
from seabreeze_param_tpu_torch.ops import distance as tdist

SENTINEL = np.float32(12000.0)
#: The card tests' grids: (nlat, nlon, (lat0, lat1, lon0, lon1)).
GRIDS = {
    "regional64": (64, 64, (7.0, -24.5, 100.0, 132.0)),
    "global121": (121, 240, (90.0, -90.0, 0.0, 360.0)),
    "ragged37x70": (37, 70, (10.0, -8.0, 100.0, 135.0)),
    "tiny10x20": (10, 20, (5.0, 0.5, 100.0, 110.0)),
}


def _grid(nlat, nlon, lat0, lat1, lon0, lon1):
    lat = np.linspace(lat0, lat1, nlat).astype(np.float32)
    lon = np.linspace(lon0, lon1, nlon, endpoint=False).astype(np.float32)
    return lat, lon


def test_fused_distance_matches_jax_pallas_at_k95():
    """``coast_distance(impl='fused')`` against the JAX package's
    ``coast_distance(impl='pallas', interpret=True)`` at k = 95, past the
    k = 88 that the port's first B3 design could hold."""
    nlat, nlon, spacing = 80, 96, 0.015
    lat, lon = _grid(nlat, nlon, 58.0, 58.0 - (nlat - 1) * spacing, 0.0,
                     nlon * spacing)
    lsm, *_, ci = make_world(nlat, nlon, 1, 1, seed=3)
    grid = Grid(lon=lon, lat=lat)
    k = tdist.effective_radius(grid, 180.0)
    assert k == 95
    got = tdist.coast_distance(
        tco.get_edges(torch.as_tensor(lsm), torch.as_tensor(ci[0])),
        torch.as_tensor(lsm), grid, 180.0, impl="fused").numpy()
    ref = np.asarray(jdist.coast_distance(
        jco.get_edges(lsm, ci[0]), lsm, JGrid(lon=lon, lat=lat), 180.0,
        impl="pallas", interpret=True))
    sent = ref == SENTINEL
    assert (ref[~sent] > 0).any() and (ref[~sent] < 0).any()  # land and sea
    np.testing.assert_array_equal(got == SENTINEL, sent)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_allclose(got[~sent], ref[~sent], rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("impl", ["fused", "hybrid"])
def test_distances_match_jax_xla_at_k387(impl):
    """The port's fused and hybrid distances against the JAX package's
    ``coast_distance(impl='xla')`` at k = 387, the radius of a 0.4 km grid
    (0.0036 degrees from 54 N), past the widest that B3's shared-memory
    builds (354) and B2's staged build (175) hold: a 16 x 400 world, whose
    400 columns let ``effective_radius`` reach 387."""
    nlat, nlon, spacing = 16, 400, 0.0036
    lat, lon = _grid(nlat, nlon, 54.0, 54.0 - (nlat - 1) * spacing, 0.0,
                     nlon * spacing)
    lsm, *_, ci = make_world(nlat, nlon, 1, 1, seed=3)
    grid = Grid(lon=lon, lat=lat)
    k = tdist.effective_radius(grid, 180.0)
    assert k == 387
    got = tdist.coast_distance(
        tco.get_edges(torch.as_tensor(lsm), torch.as_tensor(ci[0])),
        torch.as_tensor(lsm), grid, 180.0, impl=impl).numpy()
    ref = np.asarray(jdist.coast_distance(
        jco.get_edges(lsm, ci[0]), lsm, JGrid(lon=lon, lat=lat), 180.0,
        impl="xla"))
    sent = ref == SENTINEL
    assert (ref[~sent] > 0).any() and (ref[~sent] < 0).any()  # land and sea
    np.testing.assert_array_equal(got == SENTINEL, sent)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_allclose(got[~sent], ref[~sent], rtol=2e-5, atol=2e-3)


def _monotone_by_taps(table, k):
    """window_monotone, one tap at a time."""
    out = []
    for row in np.asarray(table):
        left = all(row[j + 1] <= row[j] for j in range(k))
        right = all(row[j + 1] >= row[j] for j in range(k, 2 * k))
        out.append(left and right)
    return np.array(out, bool)


@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("k", [0, 1, 6, 15])
def test_window_monotone_on_test_grids(name, k):
    """The flags of sdlam2 agree with a loop over every tap; a global
    uniform grid's every column has the property, a regional grid's every
    column at least k from its seam."""
    nlat, nlon, box = GRIDS[name]
    lat, lon = _grid(nlat, nlon, *box)
    _, _, sdlam2 = tdist.distance_tables(Grid(lon=lon, lat=lat), k)
    cols = tdist.window_monotone(sdlam2, k)
    np.testing.assert_array_equal(cols, _monotone_by_taps(sdlam2, k))
    if name == "global121":
        assert cols.all()
    else:
        assert cols[k:nlon - k].all()


def test_window_monotone_regional_seam():
    """On a regional grid the periodic wrap jumps by the domain's width:
    every column within k of the seam loses the property, every other
    keeps it (the fine world of the card's smoke, 1024 columns, k = 93)."""
    lat, lon = _grid(64, 1024, 55.0, 55.0 - 63 * 0.015, 0.0, 1024 * 0.015)
    k = 93
    _, _, sdlam2 = tdist.distance_tables(Grid(lon=lon, lat=lat), k)
    cols = tdist.window_monotone(sdlam2, k)
    np.testing.assert_array_equal(cols, _monotone_by_taps(sdlam2, k))
    inner = np.zeros(1024, bool)
    inner[k:1024 - k] = True
    assert cols[inner].all()
    assert not cols[:k - 1].any() and not cols[1024 - k + 1:].any()


def test_window_monotone_refuses_rough_tables():
    """Tables without the property: random values, a dip beside the
    centre, a rise before it, NaN."""
    k = 4
    rng = np.random.default_rng(0)
    good = np.abs(np.arange(-k, k + 1, dtype=np.float32))[None, :] ** 2
    dip = good.copy()
    dip[0, k + 2] = 0.5                           # falls right of the centre
    rise = good.copy()
    rise[0, 1] = 20.0                             # rises left of the centre
    nan = good.copy()
    nan[0, 0] = np.nan
    flat = np.zeros((1, 2 * k + 1), np.float32)   # ties keep the property
    table = np.concatenate([rng.random((5, 2 * k + 1), np.float32), dip,
                            rise, nan, good, flat])
    got = tdist.window_monotone(table, k)
    np.testing.assert_array_equal(got, _monotone_by_taps(table, k))
    np.testing.assert_array_equal(got[5:], [False, False, False, True, True])
    assert not got[:5].any()


def test_distance_tables_select_carries_flags():
    """``device_tables`` unpacks as the three tables; ``select`` by slices
    and by index tensors picks rows, columns and the columns' flags
    alike."""
    lat, lon = _grid(37, 70, *GRIDS["ragged37x70"][2])
    k = 5
    tabs = tdist.device_tables(Grid(lon=lon, lat=lat), k, "cpu")
    sdphi2, po, sdlam2 = tabs
    flags = tabs.monotone
    assert flags.dtype == torch.uint8 and flags.shape == (70,)
    np.testing.assert_array_equal(flags.numpy(), tdist.window_monotone(
        sdlam2.numpy(), k).astype(np.uint8))
    assert 0 < int(flags.sum()) < 70               # the seam's columns not
    part = tabs.select(slice(3, 20), slice(10, 40))
    ridx, cidx = torch.tensor([0, 0, 5, 36]), torch.tensor([69, 0, 1])
    picked = tabs.select(ridx, cidx)
    for sub, r, c in ((part, slice(3, 20), slice(10, 40)),
                      (picked, ridx, cidx)):
        s_sdphi2, s_po, s_sdlam2 = sub
        assert torch.equal(s_sdphi2, sdphi2[r]) and torch.equal(s_po, po[r])
        assert torch.equal(s_sdlam2, sdlam2[c])
        assert torch.equal(sub.monotone, flags[c])
        assert s_sdphi2.is_contiguous() and s_sdlam2.is_contiguous()
