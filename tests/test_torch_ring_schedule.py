"""The schedule of the ring kernels' sweep build, on the CPU.

On the card kernels B1, B4 and B5 take ring radii NN past 2047 through the
sweep build of ``csrc/ring_trigger.cu``: every hp and vc running sum is
its own chain, run once per field (a catch-up from order 0, then one
launch per band of radii in which the elements a window reads advance
and write what the windows read into a band buffer, while the windows
take the band before's).  ``tools/ring_sweep_model.py`` runs that schedule
lane by lane with the kernels' index arithmetic (which warp and lane owns
each element, the warp's staged cells and each lane's register windows,
where each window reads each value).  Here it is held bit-equal to the
plain version, ``ops.ring_search.ring_thc_from_padded``, on small fields:
radii from 1 to 60, band and split sizes as parameters, ragged shapes,
mixed latch radii, and B1's partial ever-coastal set.  The rounded land
count past 2047 cannot show at these sizes; ``tests/test_torch_cuda.py``
holds the kernels there on the card and ``tests/test_torch_large_nn.py``
the plain version against JAX.  The model's :func:`chain_floor`, the
least work of a bit-equal schedule (``chip_smoke.py`` prints it beside
the bound), is held to a count by brute force.
"""
import numpy as np
import pytest
import torch

from seabreeze_param_tpu_torch.ops.ring_search import (ring_quantities,
                                                       ring_thc_from_padded)
from tools.ring_sweep_model import (TILE, chain_floor, latch, sweep_band,
                                    sweep_thc)

MAXDIST = 180.0


def _inputs(h, w, nn, coast, seed=0):
    """NN-padded (t0, cdist) of one step and the field's cdist: 'line' a
    diagonal coast, 'land' every cell land within maxdist (each runs to
    NN), 'blobs' scattered sea cells in land (latch radii from 1 to a few
    tens), 'all' a vertical coast across the field, 'none' no cell within
    maxdist."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[-nn:h + nn, -nn:w + nn].astype(np.float32)
    if coast == "land":
        cd = 50.0 + 100.0 * rng.random(y.shape)
    elif coast == "blobs":
        cd = (np.where(rng.random(y.shape) < 0.01, -30.0, 40.0)
              + rng.random(y.shape))
    elif coast == "all":
        cd = np.clip((x - w // 2) * (360.0 / max(w, 2)), -180.0, 180.0)
    elif coast == "none":
        cd = 500.0 + 100.0 * rng.random(y.shape)
    else:
        cd = (x + 0.5 * y - w // 3) * 10.0
    cd = np.where(cd == 0, 1.0, cd).astype(np.float32)
    t0 = (280.0 + 10.0 * rng.random(y.shape)).astype(np.float32)
    return t0, cd, cd[nn:nn + h, nn:nn + w]


def _plain(t0, cd_pad, cd, nn, run=None):
    T = torch.as_tensor
    coastal = T(np.abs(cd) <= np.float32(MAXDIST))
    if run is not None:
        coastal &= T(run)
    return ring_thc_from_padded(ring_quantities(T(t0), T(cd_pad)),
                                torch.where(T(cd) >= 0, 1.0, -1.0), nn,
                                coastal=coastal)[0].numpy()


#: (h, w, NN, coast, band, hp columns a lane, vc rows a lane): sub-tile,
#: one-row and one-cell fields, ragged ones, fields wider than a warp's
#: hp columns (several column groups) and taller than its vc rows.
CASES = [
    (10, 20, 1, "line", 8, 4, 8),
    (10, 20, 5, "line", 4, 4, 8),
    (37, 70, 23, "line", 8, 4, 8),
    (16, 32, 40, "land", 16, 4, 8),
    (3, 300, 60, "blobs", 16, 4, 8),
    (37, 150, 30, "blobs", 8, 2, 4),
    (40, 9, 33, "all", 8, 1, 2),
    (1, 1, 7, "land", 4, 4, 8),
    (3, 140, 12, "line", 64, 8, 2),
    (20, 40, 9, "none", 8, 4, 8),
    (18, 260, 26, "blobs", 32, 4, 8),
]


@pytest.mark.parametrize("h,w,nn,coast,band,hc,vr", CASES)
def test_sweep_schedule_bit_equal_to_plain(h, w, nn, coast, band, hc, vr):
    """n_thc of the sweep's schedule equals the plain version's bit for
    bit, every window reading a value written in its own band by the one
    lane that advanced its element in that launch; every chain the
    schedule runs at least the floor's work."""
    t0, cd_pad, cd = _inputs(h, w, nn, coast, seed=nn)
    stats = {}
    got = sweep_thc(t0, cd_pad, cd, nn, MAXDIST, band=band, hc=hc, vr=vr,
                    stats=stats)
    np.testing.assert_array_equal(got, _plain(t0, cd_pad, cd, nn))
    rc, _ = latch(cd_pad, cd, nn, np.abs(cd) <= np.float32(MAXDIST))
    floor = chain_floor(rc, nn)
    assert stats["R"] == rc.max()
    assert stats["window"] == floor["window"]
    assert stats["catchup"] + stats["sweep"] >= floor["hp"] + floor["vc"]
    if coast == "none":
        assert stats["catchup"] == stats["sweep"] == 0


@pytest.mark.parametrize("part", ["band", "checker"])
def test_sweep_schedule_partial_ever_set(part):
    """B1's launch on a partial ever-coastal set: only the cells of its
    tiles run (the others keep the caller's pre-fill, so n_thc is 0 there
    in the model); the latch radii, and so the chains run, are those of
    the running cells alone."""
    h, w, nn = 40, 100, 20
    t0, cd_pad, cd = _inputs(h, w, nn, "blobs", seed=3)
    ty, tx = np.mgrid[0:h, 0:w]
    ti, tj = ty // TILE[0], tx // TILE[1]
    run = (ti == 1) if part == "band" else ((ti + tj) % 2 == 0)
    got = sweep_thc(t0, cd_pad, cd, nn, MAXDIST, run=run, band=8)
    np.testing.assert_array_equal(got, _plain(t0, cd_pad, cd, nn, run))
    assert (got[~run] == 0).all()


def test_sweep_schedule_mixed_latches_row_groups():
    """Latch radii from 1 to NN in one field (land, one sea cell and a sea
    column far east: the western cells run to NN), so warps' columns and
    rows stop at different radii and the bands past most cells' latches
    run only the chains that some window still reads."""
    h, w, nn = 24, 90, 48
    t0, cd_pad, cd = _inputs(h, w, nn, "land", seed=9)
    cd_pad = cd_pad.copy()
    cd_pad[nn + 17, nn + 60] = -20.0
    cd_pad[:, nn + 85] = -40.0
    cd = cd_pad[nn:nn + h, nn:nn + w]
    stats = {}
    got = sweep_thc(t0, cd_pad, cd, nn, MAXDIST, band=8, stats=stats)
    np.testing.assert_array_equal(got, _plain(t0, cd_pad, cd, nn))
    rc, _ = latch(cd_pad, cd, nn, np.abs(cd) <= np.float32(MAXDIST))
    assert rc.min() == 1 and rc.max() == nn == stats["R"]


def test_chain_floor_by_brute_force():
    """chain_floor's element counts against a direct walk over every
    window read: each hp element's greatest order read, each vc element's
    greatest order read (radius - 1), each cell's radii."""
    rng = np.random.default_rng(1)
    h, w, nn = 6, 9, 7
    rc = rng.integers(0, nn + 1, size=(h, w))
    hp, vc = {}, {}
    for y in range(h):
        for x in range(w):
            for k in range(1, rc[y, x] + 1):
                for e in (y - k, y + k):
                    hp[e, x] = max(hp.get((e, x), 0), k)
                for ep in (x - k, x + k):
                    vc[y, ep] = max(vc.get((y, ep), 0), k - 1)
    floor = chain_floor(rc, nn)
    assert floor["hp"] == sum(hp.values())
    assert floor["vc"] == sum(vc.values())
    assert floor["window"] == rc.sum()
    assert floor["adds"] == 4 * (floor["hp"] + floor["vc"]) + 8 * rc.sum()


@pytest.mark.parametrize("shape,band", [((64, 128), 64), ((32, 2200), 16),
                                        ((40, 4400), 8), ((1024, 1024), 8)])
def test_sweep_band_of_the_launcher(shape, band):
    """The band the launcher takes (the widest of 64 to 8 whose two buffers
    fit 128 MB): 64 on the smoke's 64 x 128 land field, 16 on the 1 km
    strip, 8 on a 40 x 4400 field and on a 1024 x 1024 world."""
    assert sweep_band(*shape) == band
