"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Imports nothing of JAX, so it also runs where JAX is absent; there the
repo's conftest (which imports JAX) is skipped:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips: the kernels have no CPU mode.
Grids include a ragged tile edge (37 x 70) and a grid smaller than one
tile (10 x 20), whose wrap seam pushes the ring radius up.  Kernels B1 and
B3 carry ``TriggerPipeline.run`` (B2 its hybrid distance), B3 also takes
every radius (past ``min_haversine_limits``, 354, its large build; B2
past ``pass2_min_limits``, 175, its unstaged build), B4 the per-step
coupling path, B5 the ring search alone, B6 the halo exchange of the
decomposed run (``ShardedPipeline``), on ragged, 1-wide and 64-shard
meshes.  B1, B4 and B5 run ring radii from 1 to 2204, past the 2047 at
which the window's cell count passes 2^24 and the float32 land count
rounds (from 52 on their large build, past 2047 on their sweep build;
``ring_limits``).  B2's
two-extremum form (``pass2_min_two_cuda``) runs on the same shapes as its
single form, with negative po, signed zeros and Mmax equal to Mmin, and on
the grid's tables at k = 387, where its exit fires.  The nearest lon form's hybrid run (torch
pass 1 + B2) is held to its plain path at 0.25 deg.
"""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.coupling import CoupledTrigger
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.coastline import get_edges
from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
    min_haversine_limits, min_haversine_param_cuda, pass2_min_cuda,
    pass2_min_limits, pass2_min_two_cuda, pass2_min_two_limits)
from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import halo_exchange_cuda
from seabreeze_param_tpu_torch.ops.cuda import ring_kernel
from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
    StackedScan, land_image_cuda, land_image_plain, ring_limits,
    ring_thc_cuda_padded, ring_trigger_cuda_padded, ring_trigger_cuda_stacked)
from seabreeze_param_tpu_torch.ops.distance import (
    DistanceTables, device_tables, min_haversine_param_from_padded, pad_coast,
    pass1_extrema, pass2_min, window_monotone)
from seabreeze_param_tpu_torch.ops.ring_search import (ring_quantities,
                                                       ring_thc_from_padded)
from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                   trigger_cells)
from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain
from seabreeze_param_tpu_torch.parallel.mesh import ShardMesh, make_mesh, split
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline
from tools.pruned_model import pass2_centre_out, pass2_two_centre_out

MISSING = np.float32(2.0e20)
GRIDS = {
    "regional64": (64, 64, (7.0, -24.5, 100.0, 132.0)),
    "global121": (121, 240, (90.0, -90.0, 0.0, 360.0)),
    "ragged37x70": (37, 70, (10.0, -8.0, 100.0, 135.0)),
    "tiny10x20": (10, 20, (5.0, 0.5, 100.0, 110.0)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _world(name, nt=3):
    nlat, nlon, (lat0, lat1, lon0, lon1) = GRIDS[name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, nt,
                                                    seed=11)
    ci[:] = 0.0
    ci[1:, : max(1, nlat // 8), :] = 0.9     # ice appears at step 1
    lat = np.linspace(lat0, lat1, nlat).astype(np.float32)
    lon = np.linspace(lon0, lon1, nlon, endpoint=False).astype(np.float32)
    return Grid(lon=lon, lat=lat), (lsm, z, std, pres, theta, u, v, ci)


def _close(got, ref, what):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    miss = ref == MISSING
    np.testing.assert_array_equal(got == MISSING, miss, err_msg=what)
    np.testing.assert_allclose(got[~miss], ref[~miss], rtol=2e-5, atol=2e-4,
                               err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_pass2_kernel_bit_equal_to_plain(name, dev):
    grid, (lsm, *_, ci) = _world(name)
    pipe = TriggerPipeline(grid, device=dev)
    k = pipe.k
    sdphi2, po, sdlam2 = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci[1], device=dev))
    Mmin, _ = pass1_extrema(pad_coast(coast, k), sdlam2, k)
    before = pass2_min_cuda.launches
    got = pass2_min_cuda(Mmin, sdphi2, po, k)
    assert pass2_min_cuda.launches == before + 1
    torch.testing.assert_close(got, pass2_min(Mmin, sdphi2, po, k), rtol=0,
                               atol=0)


#: (h, w) of B2's outputs: under one 16 x 128 tile, exactly one tile,
#: ragged in both axes, a width that is no multiple of four (the 4-byte
#: copies), several whole tiles, and the 0.25-degree field.
PASS2_SHAPES = [(3, 20), (16, 128), (37, 70), (45, 301), (64, 256),
                (721, 1440)]


def _v_rows(rng, h, k):
    """(h, 2k+1) rows that fall from either end to 0 at the centre tap, the
    first rows' leading taps BIG (the lat edge): every row has the
    property of ``window_monotone``."""
    left = -np.sort(-rng.random((h, k)), axis=1)
    right = np.sort(rng.random((h, k)), axis=1)
    t = np.concatenate([left, np.zeros((h, 1)), right], axis=1)
    for y in range(min(h, k)):
        t[y, : k - y] = 1.0e30
    return t.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PASS2_SHAPES)
@pytest.mark.parametrize("k", [0, 1, 6, 15, 176, 310, 387, 1000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows", ["random", "monotone"])
def test_pass2_kernel_shapes_bit_equal_to_plain(shape, k, offset, rows, dev):
    """B2 against its plain version, bit for bit, on random Mmin with BIG
    rows, BIG blocks and BIG cells, at k = 0 (one tap) to 15 and past the
    staged build's widest radius (175, ``pass2_min_limits``; the unstaged
    build: a 0.5 km grid's 310, a 0.4 km grid's 387, 1000), where the
    launcher once raised; ``offset`` 1 places Mmin and so its rows off the
    16-byte alignment (the scalar path).  ``rows``: random sdphi2 rows (no
    row has the monotone property) or rows that fall to the centre tap
    (every row has it, the first rows BIG at the lat edge), each with the
    rows' flags and without (the unstaged build's early exit and every
    tap)."""
    assert pass2_min_limits() == 175
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w + k)
    m = rng.random((h + 2 * k, w)).astype(np.float32)
    m[rng.random(h + 2 * k) < 0.3] = 1.0e30
    m[:, : w // 3][: (h + 2 * k) // 2] = 1.0e30
    m[rng.random(m.shape) < 0.1] = 1.0e30
    buf = torch.empty(m.size + offset, device=dev)
    Mmin = buf[offset:].view(m.shape)
    Mmin.copy_(torch.as_tensor(m))
    t = (rng.random((h, 2 * k + 1)).astype(np.float32) if rows == "random"
         else _v_rows(rng, h, k))
    flags = window_monotone(t, k)
    assert flags.all() if rows == "monotone" else k < 2 or not flags.any()
    sdphi2 = torch.as_tensor(t, device=dev)
    po = torch.as_tensor(rng.random((h, 2 * k + 1)).astype(np.float32),
                         device=dev)
    ref = pass2_min(Mmin, sdphi2, po, k)
    for row_mono in (torch.as_tensor(flags.astype(np.uint8), device=dev),
                     None):
        before = pass2_min_cuda.launches
        got = pass2_min_cuda(Mmin, sdphi2, po, k, row_monotone=row_mono)
        assert pass2_min_cuda.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


#: Kinds of B2's two-extremum inputs: random sdphi2 rows and po in [-1, 1];
#: the grid-like tables (rows falling to +0 at the centre tap, po >= 0),
#: where the form equals the single one; po in [-1, 1] with +-0 at the
#: centre tap; Mmax equal to Mmin (BIG where a window is empty).
TWO_KINDS = ("random", "tables", "signed_zero", "equal")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PASS2_SHAPES)
@pytest.mark.parametrize("k", [0, 1, 6, 15, 93, 94, 175, 387, 1000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", TWO_KINDS)
def test_pass2_two_extremum_bit_equal_to_plain(shape, k, offset, kind, dev):
    """B2's two-extremum form against its plain version
    (``pass2_min(Mmax=)``), bit for bit (signed zeros included): random
    extrema (Mmax >= Mmin, BIG / -BIG rows, blocks and cells) under each of
    :data:`TWO_KINDS`, at k = 0 to 15, at each side of the staged build's
    widest radius (93, ``pass2_min_two_limits``: its shared-memory limit
    and the measured crossover to the pruned build), and at 175, 387 and
    1000 on the pruned build with its exit;
    ``offset`` 1 places both extrema off the 16-byte alignment.  The rows'
    flags, which this form does not read, are passed and not.  With po in
    [-1, 1] the form differs from the single one; on the grid-like tables
    and with Mmax equal to Mmin it equals it."""
    assert pass2_min_two_limits() == 93
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w + k + 7)
    m = rng.random((h + 2 * k, w)).astype(np.float32)
    mx = np.maximum(m, rng.random(m.shape).astype(np.float32))
    empty = rng.random(h + 2 * k) < 0.3
    empty = empty[:, None] | (rng.random(m.shape) < 0.1)
    empty[: (h + 2 * k) // 2, : w // 3] = True
    m[empty], mx[empty] = 1.0e30, -1.0e30
    if kind == "equal":
        mx = m.copy()
    buf = torch.empty(2 * m.size + 2 * offset, device=dev)
    Mmin = buf[offset:offset + m.size].view(m.shape)
    Mmax = buf[m.size + 2 * offset:].view(m.shape)
    Mmin.copy_(torch.as_tensor(m))
    Mmax.copy_(torch.as_tensor(mx))
    t = (rng.random((h, 2 * k + 1)).astype(np.float32) if kind == "random"
         else _v_rows(rng, h, k))
    flags = torch.as_tensor(window_monotone(t, k).astype(np.uint8),
                            device=dev)
    q = (2 * rng.random((h, 2 * k + 1)) - 1).astype(np.float32)
    if kind == "tables":
        q = np.abs(q)
    elif kind == "signed_zero":
        q[:, k] = np.where(np.arange(h) % 2 == 0, np.float32(-0.0),
                           np.float32(0.0))
    sdphi2 = torch.as_tensor(t, device=dev)
    po = torch.as_tensor(q, device=dev)
    ref = pass2_min(Mmin, sdphi2, po, k, Mmax=Mmax)
    single = pass2_min(Mmin, sdphi2, po, k)
    assert bool((ref <= single).all())
    if kind in ("tables", "equal"):
        assert torch.equal(ref.view(torch.int32), single.view(torch.int32))
    elif h * w >= 256 and (k or kind == "random"):
        # a few rows may all take po >= 0 or empty windows; at k = 0 the
        # signed zeros leave the one tap's po at 0
        assert bool((ref < single).any())
    for row_mono in (flags, None):
        before = (pass2_min_two_cuda.launches, pass2_min_cuda.launches)
        got = pass2_min_cuda(Mmin, sdphi2, po, k, Mmax=Mmax,
                             row_monotone=row_mono)
        assert (pass2_min_two_cuda.launches,
                pass2_min_cuda.launches) == (before[0] + 1, before[1])
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    got = pass2_min_two_cuda(Mmin, Mmax, sdphi2, po, k)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_ring_kernel_matches_plain(name, tt, dev):
    """One step: the slot within 2e-5/2e-4 with MISSING structure equal,
    the wind state bit-equal, across seeding (1), a plain step (5) and a
    refresh (15)."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    params = Params()
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pipe = TriggerPipeline(grid, device=dev)
    nn = pipe.nn_max + 4
    cd = pipe.distance_field(D(lsm), D(ci[1]))
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[1]), D(u[1]), D(v[1]), cd, D(z), D(std), D(pres), params, nn)
    rng = np.random.default_rng(tt)
    ws0 = D((5 + rng.random(lsm.shape)).astype(np.float32))
    wd0 = D((360 * rng.random(lsm.shape) - 180).astype(np.float32))
    is_first, upd = cadence(tt, params)
    ws_s, wd_s = ws0.clone(), wd0.clone()
    scan = StackedScan(*lsm.shape, params, dev)
    bufs = scan.init_buffers(2, ws0, wd0)
    before = ring_trigger_cuda_stacked.launches
    ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s, wd_s,
                              is_first, upd, params, nn, 1, *bufs,
                              scan.add_coastal(cd))
    assert ring_trigger_cuda_stacked.launches == before + 1
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                        is_first, upd, params, nn)
    for got, want, what in zip((bufs[0][1], bufs[1][1], bufs[2][1]), ref,
                               ("sb", "ws", "wd")):
        _close(got, want, what)
    torch.testing.assert_close(ws_s, ref[3], rtol=0, atol=0)
    torch.testing.assert_close(wd_s, ref[4], rtol=0, atol=0)
    # slot 0 was never written: it keeps the pre-fill
    assert (bufs[0][0][:-1] == float(MISSING)).all()


#: (h, w) of B1's edge cases: under one tile, exactly one 16 x 32 tile,
#: ragged in both axes, several tile rows and columns.
RING_SHAPES = [(10, 20), (16, 32), (37, 70), (64, 160)]


def _ring_step(shape, nn, coast, shift, dev, seed=0):
    """Random NN-padded ring inputs of one step and the step's fields:
    ``coast`` 'none' (no cell within maxdist), 'all' (every cell, land on
    one side of a vertical coast 10 km per column away), 'line' (a
    diagonal coast, moved ``shift`` columns) or 'land' (every cell land
    within maxdist, so no window ever holds both classes and every cell
    runs to NN)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[-nn:h + nn, -nn:w + nn].astype(np.float32)
    if coast == "none":
        cd = 500.0 + 100.0 * rng.random(y.shape)
    elif coast == "all":
        cd = np.clip((x - w // 2) * (360.0 / max(w, 2)), -180.0, 180.0)
    elif coast == "land":
        cd = 50.0 + 100.0 * rng.random(y.shape)
    else:
        cd = (x + 0.5 * y - w // 3 - shift) * 10.0
    cd = np.where(cd == 0, 1.0, cd).astype(np.float32)
    t0 = (280.0 + 10.0 * rng.random(y.shape)).astype(np.float32)
    D = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    wind = [D((5 + 3 * rng.random(shape)).astype(np.float32)),
            D((360 * rng.random(shape) - 180).astype(np.float32))]
    return D(t0), D(cd), D(cd[nn:nn + h, nn:nn + w]), wind


def _ring_padded_both(t0_pad, cd_pad, cd, ws_new, wd_new, ws0, wd0, flags,
                      params, nn):
    """B4 and B5 against their plain versions, bit for bit."""
    before = (ring_trigger_cuda_padded.launches, ring_thc_cuda_padded.launches)
    got = ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new, wd_new, ws0,
                                   wd0, *flags, params, nn)
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad, *flags,
                        params, nn)
    for g, want in zip(got, (ref[0], ref[3], ref[4])):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    n_thc = ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)
    want, _ = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                                   torch.where(cd >= 0, 1.0, -1.0), nn,
                                   coastal=cd.abs() <= 180.0)
    torch.testing.assert_close(n_thc, want, rtol=0, atol=0)
    assert (ring_trigger_cuda_padded.launches,
            ring_thc_cuda_padded.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RING_SHAPES)
@pytest.mark.parametrize("nn", [1, 10, 19, 25, 37, 51, 52, 53, 57, 58, 65, 97,
                                109, 110, 160, 224, 225, 243, 320, 2047])
@pytest.mark.parametrize("coast", ["none", "all", "line", "land"])
def test_ring_stacked_two_steps_bit_equal_to_plain(shape, nn, coast, dev):
    """B1 over two steps of one scan from tt = 14 (the coast moving between
    them, so a tile can be ever-coastal and not coastal now), against
    ``trigger_cells`` step by step: every slot and the wind state bit for
    bit, with no ever-coastal tile ('none'), every tile ('all'), a band,
    or every cell running to NN ('land'); B4 and B5 on the same steps.  NN
    1 to 24 is the first build (4 hp and 3 vc elements per thread), 25 to
    51 the second (9 and 5).  From 52 on the large build (radii in bands
    of 16, the elements a band reads carried in registers, latch radii
    from an integral image of land): 97 is the 0.015-degree regional
    grid's static bound, 208 the radius ``diag`` probes there, 224 the
    widest radius of the large build before its redesign, 243 the radius
    ``diag`` probes on a 0.009-degree (1 km) grid, 320 well past it, 2047
    the widest with exact float32 land counts (past it:
    test_ring_kernels_past_2047_bit_equal_to_plain)."""
    _ring_two_steps(shape, nn, coast, dev)


def _ring_two_steps(shape, nn, coast, dev):
    """B1 over two steps at radius ``nn`` against ``trigger_cells``, and
    B4 and B5 on the same steps, bit for bit."""
    params = Params()
    h, w = shape
    rng = np.random.default_rng(nn)
    ws0 = torch.as_tensor((5 + rng.random(shape)).astype(np.float32),
                          device=dev)
    wd0 = torch.as_tensor((360 * rng.random(shape) - 180).astype(np.float32),
                          device=dev)
    scan = StackedScan(h, w, params, dev)
    bufs = scan.init_buffers(2, ws0, wd0)
    ws_s, wd_s = ws0.clone(), wd0.clone()
    ws_p, wd_p = ws0.clone(), wd0.clone()
    for t in range(2):
        t0_pad, cd_pad, cd, (ws_new, wd_new) = _ring_step(
            shape, nn, coast, 6 * t, dev, seed=t)
        flags = cadence(14 + t, params)
        before = ring_trigger_cuda_stacked.launches
        ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s,
                                  wd_s, *flags, params, nn, t, *bufs,
                                  scan.add_coastal(cd))
        assert ring_trigger_cuda_stacked.launches == before + 1
        ref = trigger_cells(cd, ws_new, wd_new, ws_p, wd_p, t0_pad, cd_pad,
                            *flags, params, nn)
        for b, want in zip(bufs, ref):
            torch.testing.assert_close(b[t], want, rtol=0, atol=0)
        _ring_padded_both(t0_pad, cd_pad, cd, ws_new, wd_new, ws_p, wd_p,
                          flags, params, nn)
        ws_p, wd_p = ref[3], ref[4]
        torch.testing.assert_close(ws_s, ws_p, rtol=0, atol=0)
        torch.testing.assert_close(wd_s, wd_p, rtol=0, atol=0)
    if coast == "none":
        assert int(scan.ever.sum()) == 0
    if coast == "all":
        assert bool(scan.ever.all())


def _ring_launch_all(dev, h, w, nn, params):
    """One launch of each of B1, B4 and B5 on zero fields padded at
    ``nn``."""
    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    pads = (zeros(h + 2 * nn, w + 2 * nn), zeros(h + 2 * nn, w + 2 * nn))
    scan = StackedScan(h, w, params, dev)
    bufs = scan.init_buffers(1, zeros(h, w), zeros(h, w))
    yield lambda: ring_trigger_cuda_stacked(
        *pads, *(zeros(h, w) for _ in range(5)), False, False, params, nn, 0,
        *bufs, scan.ever)
    yield lambda: ring_trigger_cuda_padded(
        *pads, *(zeros(h, w) for _ in range(5)), False, False, params, nn)
    yield lambda: ring_thc_cuda_padded(*pads, zeros(h, w), nn)


def _ring_counts():
    return (ring_trigger_cuda_stacked.launches,
            ring_trigger_cuda_padded.launches, ring_thc_cuda_padded.launches)


@pytest.mark.cuda
def test_ring_launchers_take_nn_243(dev):
    """NN = 243, the radius ``diag`` probes on a 1 km grid
    (``tools/ring_nn.py``) and past the large build's old limit of 224: B1,
    B4 and B5 each launch once (their results: test_ring_stacked_two_steps_
    bit_equal_to_plain)."""
    large_from, max_nn = ring_limits()
    assert large_from <= 58 and max_nn >= 243
    for k, launch in enumerate(_ring_launch_all(dev, 8, 8, 243, Params())):
        before = _ring_counts()
        launch()
        torch.cuda.synchronize()
        want = list(before)
        want[k] += 1
        assert _ring_counts() == tuple(want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RING_SHAPES)
@pytest.mark.parametrize("nn", [2047, 2048, 2204])
@pytest.mark.parametrize("coast", ["none", "all", "line", "land"])
def test_ring_kernels_past_2047_bit_equal_to_plain(shape, nn, coast, dev):
    """B1, B4 and B5 past the radius at which the window's cell count,
    (2 NN + 1)^2, passes 2^24 (2047), where the plain version's float32
    land count rounds and the kernels once refused: bit-equal to plain over
    two steps at 2047, 2048 and 2204 (the static bound of a 1 km grid with
    maxdist = 3000 km, k = 2200), on the coast shapes of
    test_ring_stacked_two_steps_bit_equal_to_plain, 'land' being the field
    whose windows never hold both classes, so every cell carries the
    rounded count to NN."""
    _ring_two_steps(shape, nn, coast, dev)


def _past_field(kind, nn, t, dev):
    """One step's ring inputs of a field past NN = 2047 (seed ``t``):
    'many_tiles' 600 x 128 land cells within maxdist (152 coastal 16 x 32
    tiles, more than an H100's 132 SMs; every cell runs to NN); 'mixed' 64
    x 160 land with a sea column 2048 - w/2 columns past the field's last
    (moved a column at step 1), so the western cells latch past 2047 on the
    rounded land count and the eastern ones below it; 'partial' 600 x 128
    land whose rows within maxdist are 0-199 at step 0 and 150-349 at step
    1 (B1's ever-coastal set a part of its tiles, growing); 'line' 64 x
    160 with a diagonal coast; 'over_budget' 1440 x 1440 land with a sea
    column as 'mixed' (latch radii ~1300 to past 2047), whose sweep would
    need more scratch than the kernels allow it, so the large build takes
    it."""
    h, w = ((64, 160) if kind in ("mixed", "line") else
            (1440, 1440) if kind == "over_budget" else (600, 128))
    rng = np.random.default_rng(100 + t)
    y, x = np.mgrid[-nn:h + nn, -nn:w + nn].astype(np.float32)
    cd = 50.0 + 100.0 * rng.random(y.shape)
    if kind in ("mixed", "over_budget"):
        cd[:, nn + w - 1 + 2048 - w // 2 + t] = -40.0
    elif kind == "partial":
        lo = 0 if t == 0 else 150
        cd = np.where((y >= lo) & (y < lo + 200), cd, cd + 500.0)
    elif kind == "line":
        cd = (x + 0.5 * y - w // 3 - 6 * t) * 10.0
        cd = np.where(cd == 0, 1.0, cd)
    cd = cd.astype(np.float32)
    t0 = (280.0 + 10.0 * rng.random(y.shape)).astype(np.float32)
    D = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    wind = (D((5 + 3 * rng.random((h, w))).astype(np.float32)),
            D((360 * rng.random((h, w)) - 180).astype(np.float32)))
    return D(t0), D(cd), D(cd[nn:nn + h, nn:nn + w]), wind


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nn,rows", [
    ("many_tiles", 2048, None), ("mixed", 2204, None),
    ("partial", 2048, None), ("line", 2204, (5, 0)), ("line", 2048, (3, -2)),
    ("over_budget", 2048, None)])
def test_ring_kernels_past_2047_more_fields(kind, nn, rows, dev):
    """B1 over two steps of one scan from tt = 14, and B4 and B5 on the same
    steps, bit-equal to their plain versions past NN = 2047 (the sweep
    build) on fields beyond test_ring_kernels_past_2047_bit_equal_to_plain's
    (:func:`_past_field`): more coastal tiles than the card has SMs, latch
    radii on both sides of 2047 in one field, a partial and growing
    ever-coastal set (tiles never coastal keep the pre-fill), and a block
    whose first row is global row ``row_offset`` of a grid of
    ``row_offset + h + extra`` rows (``rows``), and a field too large for
    the sweep's scratch, which the large build takes: its scratch is the
    integral image alone, every other field's more."""
    params = Params()
    steps = [_past_field(kind, nn, t, dev) for t in range(2)]
    h, w = steps[0][2].shape
    image = (h + 2 * nn + 1) * (w + 2 * nn + 1)
    scratch = ring_kernel._scratch(h, w, nn, dev).numel()
    assert (scratch == image) == (kind == "over_budget"), (scratch, image)
    if kind == "many_tiles":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert int(StackedScan(h, w, params, dev).add_coastal(
            steps[0][2]).sum()) > sms
    kw = {} if rows is None else dict(row_offset=rows[0],
                                      nlat_total=rows[0] + h + rows[1])
    rng = np.random.default_rng(nn)
    ws0, wd0 = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        5 + rng.random((h, w)), 360 * rng.random((h, w)) - 180))
    scan = StackedScan(h, w, params, dev)
    bufs = scan.init_buffers(2, ws0, wd0, **kw)
    ws_s, wd_s = ws0.clone(), wd0.clone()
    ws_p, wd_p = ws0.clone(), wd0.clone()
    for t, (t0_pad, cd_pad, cd, (ws_new, wd_new)) in enumerate(steps):
        flags = cadence(14 + t, params)
        ever = scan.add_coastal(cd)
        if kind == "partial":
            assert 0 < int(ever.sum()) < ever.numel()
        ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s,
                                  wd_s, *flags, params, nn, t, *bufs, ever,
                                  **kw)
        ref = trigger_cells(cd, ws_new, wd_new, ws_p, wd_p, t0_pad, cd_pad,
                            *flags, params, nn, **kw)
        for b, want in zip(bufs, ref):
            torch.testing.assert_close(b[t], want, rtol=0, atol=0)
        got = ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new, wd_new,
                                       ws_p, wd_p, *flags, params, nn, **kw)
        for g, want in zip(got, (ref[0], ref[3], ref[4])):
            torch.testing.assert_close(g, want, rtol=0, atol=0)
        n_thc = ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)
        want, _ = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                                       torch.where(cd >= 0, 1.0, -1.0), nn,
                                       coastal=cd.abs() <= 180.0)
        torch.testing.assert_close(n_thc, want, rtol=0, atol=0)
        ws_p, wd_p = ref[3], ref[4]
        torch.testing.assert_close(ws_s, ws_p, rtol=0, atol=0)
        torch.testing.assert_close(wd_s, wd_p, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (37, 70), (4440, 6608)])
def test_ring_land_image_equals_plain(shape, dev):
    """The integral image of land that every B1, B4 and B5 launch from NN =
    52 on starts with, launched alone (``land_image_cuda``, timed so in
    ``chip_smoke.py``), equals cumulative sums of the land mask, on a
    one-cell field, a ragged one and the 1 km strip's padded field at NN =
    2204."""
    gen = torch.Generator(device=dev).manual_seed(shape[0])
    cd_pad = torch.rand(shape, generator=gen, device=dev) - 0.5
    torch.testing.assert_close(land_image_cuda(cd_pad),
                               land_image_plain(cd_pad), rtol=0, atol=0)


@pytest.mark.cuda
def test_ring_launchers_refuse_past_the_integral_image(dev):
    """The widest radius the kernels take is the widest whose padded field
    the int32 integral image of land can count, (2 NN + 1)^2 <= 2^31 - 1:
    one past it, and a field whose padded cells pass 2^31 - 1, make B1, B4
    and B5 raise ``ValueError`` before any tensor is checked or launched
    (tiny tensors stand in for the fields)."""
    large_from, max_nn = ring_limits()
    assert large_from == 52 and max_nn == 23169
    assert (2 * max_nn + 1) ** 2 <= 2 ** 31 - 1 < (2 * max_nn + 3) ** 2
    params = Params()
    z = torch.zeros((1, 1), device=dev)
    before = _ring_counts()
    for nn, h, w, match in ((max_nn + 1, 1, 1, f"NN <= {max_nn}"),
                            (2048, 40000, 50000, "integral image")):
        cd = z.expand(h, w)
        scan = StackedScan(h, w, params, dev)
        for launch in (
                lambda: ring_trigger_cuda_stacked(
                    z, z, cd, z, z, z, z, False, False, params, nn, 0, z, z,
                    z, scan.ever),
                lambda: ring_trigger_cuda_padded(z, z, cd, z, z, z, z, False,
                                                 False, params, nn),
                lambda: ring_thc_cuda_padded(z, z, cd, nn)):
            with pytest.raises(ValueError, match=match):
                launch()
    assert _ring_counts() == before


@pytest.mark.cuda
def test_ring_stacked_many_tiles_each_written_once(dev):
    """B1 on a field of 36000 tiles, more than one round of its ranking
    (512 threads x 64 tiles), with ~2300 ever-coastal tiles in both rounds,
    many more than the persistent grid's blocks: one step at tt = 15 (a
    wind refresh, not the first step) bit-equal to plain.  A tile visited
    twice would read the state it had just written and change its sb; a
    tile left out would keep the pre-fill."""
    params = Params()
    h, w, nn = 64, 32 * 9000, 3
    rng = np.random.default_rng(5)
    x = np.arange(-nn, w + nn, dtype=np.float32)
    cd_row = ((x % 1000.0) - 500.0) * 10.0 + 5.0  # a coast every 1000 columns
    cd_full = np.broadcast_to(cd_row, (h + 2 * nn, w + 2 * nn))
    D = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    cd_pad = D(cd_full.astype(np.float32))
    t0_pad = D((280.0 + 10.0 * rng.random(cd_full.shape)).astype(np.float32))
    cd = cd_pad[nn:nn + h, nn:nn + w].contiguous()
    ws_new, ws0 = (D((5 + 3 * rng.random((h, w))).astype(np.float32))
                   for _ in range(2))
    wd_new, wd0 = (D((360 * rng.random((h, w)) - 180).astype(np.float32))
                   for _ in range(2))
    scan = StackedScan(h, w, params, dev)
    ever = scan.add_coastal(cd)
    n_ever = int(ever.sum())
    assert ever.numel() == 36000 > 512 * 64 and 2000 < n_ever < 3000
    assert int(ever[:512 * 64].sum()) < n_ever  # coastal tiles in round 2
    bufs = scan.init_buffers(1, ws0, wd0)
    ws_s, wd_s = ws0.clone(), wd0.clone()
    flags = cadence(15, params)
    assert not flags[0] and flags[1]
    ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s, wd_s,
                              *flags, params, nn, 0, *bufs, ever)
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad, *flags,
                        params, nn)
    for b, want in zip(bufs, ref):
        torch.testing.assert_close(b[0], want, rtol=0, atol=0)
    torch.testing.assert_close(ws_s, ref[3], rtol=0, atol=0)
    torch.testing.assert_close(wd_s, ref[4], rtol=0, atol=0)


@pytest.mark.cuda
def test_stacked_scan_global025_matches_plain(dev):
    """``TriggerPipeline.run`` at 0.25 deg (721 x 1440), three steps from
    tt = 14 across the refresh, ice appearing at step 1: the kernel path (B2
    + B1) against the plain path, per-step fields bit for bit and the final
    wind state bit-equal; one B1 launch per step."""
    nlat, nlon = 721, 1440
    grid = Grid.regular(nlat, nlon)
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, 3, seed=3)
    ci[1:, :70, :] = 0.8
    runs = {}
    for uk in (None, False):
        pipe = TriggerPipeline(grid, device=dev, use_kernels=uk)
        state = TriggerState(
            tt=14, thc=torch.zeros((nlat, nlon), device=dev),
            windspeed=torch.full((nlat, nlon), 5.0, device=dev),
            winddir=torch.full((nlat, nlon), 90.0, device=dev))
        before = ring_trigger_cuda_stacked.launches
        runs[uk] = pipe.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        assert ring_trigger_cuda_stacked.launches - before == (
            3 if uk is None else 0)
    (ks, ko), (ps, po) = runs[None], runs[False]
    for key in po:
        torch.testing.assert_close(ko[key], po[key], rtol=0, atol=0)
    for key in ("windspeed", "winddir"):
        torch.testing.assert_close(getattr(ks, key), getattr(ps, key),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_nearest_hybrid_scan_global025_bit_equal_to_plain(dev):
    """``TriggerPipeline(distance_lon_form='nearest').run`` at 0.25 deg,
    three steps from tt = 14 with ice appearing at step 1: ``'auto'`` takes
    the hybrid on the card (torch pass 1 in the nearest form, then B2, one
    launch a step, no B3), bit-equal to the plain path (the same form)
    step by step, with the final wind state."""
    nlat, nlon = 721, 1440
    grid = Grid.regular(nlat, nlon)
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, 4, 3, seed=3)
    ci[1:, :70, :] = 0.8
    runs = {}
    for uk in (None, False):
        pipe = TriggerPipeline(grid, device=dev, use_kernels=uk,
                               distance_lon_form="nearest")
        state = TriggerState(
            tt=14, thc=torch.zeros((nlat, nlon), device=dev),
            windspeed=torch.full((nlat, nlon), 5.0, device=dev),
            winddir=torch.full((nlat, nlon), 90.0, device=dev))
        before = (pass2_min_cuda.launches, min_haversine_param_cuda.launches,
                  ring_trigger_cuda_stacked.launches)
        runs[uk] = pipe.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        n = 3 if uk is None else 0
        assert (pass2_min_cuda.launches - before[0],
                min_haversine_param_cuda.launches - before[1],
                ring_trigger_cuda_stacked.launches - before[2]) == (n, 0, n)
    (ks, ko), (ps, po) = runs[None], runs[False]
    for key in po:
        torch.testing.assert_close(ko[key], po[key], rtol=0, atol=0)
    for key in ("windspeed", "winddir"):
        torch.testing.assert_close(getattr(ks, key), getattr(ps, key),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_diag_kernel_path_matches_plain_path(name, dev):
    """Three steps from tt=14 across the tt=15 refresh, ice appearing at
    step 1: per-step fields within 2e-5/2e-4, final wind state bit-equal,
    each kernel launched once per step (B3, the card's default distance,
    also once for the probe)."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    rng = np.random.default_rng(0)
    ws = (5 + rng.random(lsm.shape)).astype(np.float32)
    wd = (360 * rng.random(lsm.shape) - 180).astype(np.float32)
    args = (14, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    kw = dict(ws=ws, wd=wd, thc=np.zeros_like(ws), full_output=True)
    p0, r0 = (min_haversine_param_cuda.launches,
              ring_trigger_cuda_stacked.launches)
    kern = diag(*args, device=dev, **kw)
    assert ring_trigger_cuda_stacked.launches - r0 == 3
    assert min_haversine_param_cuda.launches - p0 == 4
    plain = diag(*args, device=dev, use_kernels=False, **kw)
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        _close(torch.as_tensor(kern[5][key]), torch.as_tensor(plain[5][key]),
               key)
    np.testing.assert_array_equal(kern[3], plain[3])
    np.testing.assert_array_equal(kern[4], plain[4])


#: steps of a staged call: more than the staging ring's slots
STAGED_T = 7


def _staged_world(pres3):
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world("regional64",
                                                        nt=STAGED_T)
    u = u + np.arange(u.shape[1], dtype=np.float32)[None, :, None, None]
    ci[3:, 8:12] = 0.9                       # the coastline moves again
    if pres3:
        col = 1.0 + 0.02 * np.sin(np.arange(lsm.size, dtype=np.float32))
        pres = (pres[:, None, None] * col.reshape(lsm.shape)).astype(
            np.float32)
    return grid, (lsm, z, std, pres, theta, u, v, ci)


@pytest.mark.cuda
@pytest.mark.parametrize("pres3", [False, True], ids=["pres1d", "pres3d"])
@pytest.mark.parametrize("ice", [True, False], ids=["ice", "noice"])
def test_staged_diag_bit_equal_to_unstaged_moves(ice, pres3, dev,
                                                  monkeypatch):
    """``diag`` through the staging slots and copy stream, two calls of
    7 steps (more than the ring's slots) with the state carried: bit-equal
    to the same pipeline run on device tensors moved without staging and
    read back with ``.cpu()``; the first call's arrays unchanged by the
    second."""
    from seabreeze_param_tpu_torch import api
    from seabreeze_param_tpu_torch.ops.trigger import nearest_level
    api.clear_exec_cache()
    grid, (lsm, z, std, pres, theta, u, v, ci) = _staged_world(pres3)
    ci = ci if ice else None
    seen, real = [], TriggerPipeline.run

    def run(self, *a, **kw):
        seen.append((self, kw["nn"], kw["feed"]))
        return real(self, *a, **kw)
    monkeypatch.setattr(TriggerPipeline, "run", run)
    args = (lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    first = diag(1, *args, device=dev)
    kept = [a.copy() for a in first[1:]]
    second = diag(first[0], *args, ws=first[3], wd=first[4], thc=first[2],
                  device=dev)
    assert len(seen) == 2 and all(f is not None for *_, f in seen)
    for a, b in zip(first[1:], kept):
        np.testing.assert_array_equal(a, b)

    if not pres3:                            # the one level diag moves
        lev = int(nearest_level(torch.tensor(pres),
                                Params().target_plev_pa))
        u, v, pres = u[:, lev:lev + 1], v[:, lev:lev + 1], pres[lev:lev + 1]

    def d(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), device=dev)
    zero = torch.zeros(lsm.shape, device=dev)
    state = TriggerState(1, zero, zero, zero)
    for (pipe, nn, _), got in zip(seen, (first, second)):
        state, outs = real(pipe, state, d(theta), d(u), d(v), d(lsm), d(z),
                           d(std), d(pres), ci_t=d(ci), nn=nn)
        assert got[0] == state.tt
        for have, want in zip(got[1:], (outs["sb_con"], state.thc,
                                        state.windspeed, state.winddir)):
            np.testing.assert_array_equal(have, want.cpu().numpy())


@pytest.mark.cuda
def test_staged_pinned_memory_bounded(dev):
    """20 calls whose answers the caller keeps: the stager's pinned slots,
    and the pinned memory torch has allocated, stay as after the first
    two calls.  (Its ``active_bytes`` rise by a few bytes a call
    on the unstaged path as well: not the stager's.)"""
    from seabreeze_param_tpu_torch import api, staging
    api.clear_exec_cache()
    grid, (lsm, z, std, pres, theta, u, v, ci) = _staged_world(False)
    args = (lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    kept = [diag(1, *args, device=dev) for _ in range(2)]
    stager = next(iter(api._CACHE.values())).stager()
    held = stager.host_bytes
    plane = lsm.size * 4
    assert held == staging.SLOTS * (4 + 1) * plane
    assert all(s.buf.is_pinned() for s in stager._in + stager._out)

    def pinned():
        return torch.cuda.host_memory_stats()["allocated_bytes.current"]
    before = pinned()
    kept += [diag(1, *args, device=dev) for _ in range(20)]
    assert stager.host_bytes == held
    assert held <= before and pinned() == before
    for got in kept[1:]:
        for a, b in zip(got[1:], kept[0][1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_wrappers_reject_bad_tensors(dev):
    Mmin = torch.zeros((20, 16), device=dev)
    tab = torch.zeros((10, 11), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        pass2_min_cuda(Mmin.double(), tab, tab, 5)
    with pytest.raises(ValueError, match="contiguous"):
        pass2_min_cuda(torch.zeros((16, 20), device=dev).t(), tab, tab, 5)
    with pytest.raises(ValueError, match="shape"):
        pass2_min_cuda(Mmin, tab[:, :9], tab, 5)
    with pytest.raises(ValueError, match="on cpu"):
        pass2_min_cuda(Mmin, tab.cpu(), tab, 5)


@pytest.mark.cuda
def test_launchers_reject_oversized_shared_memory(dev):
    """B2 at a radius whose strip (~1.5 MB) no block's shared memory holds
    runs its unstaged build (it once raised a cudaError_t); B1 past its
    widest radius raises ``ValueError`` and counts no launch; and the next
    good launch is not blamed for anything."""
    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    k = 1000                                  # B2: ~1.5 MB per block
    p0, r0 = pass2_min_cuda.launches, ring_trigger_cuda_stacked.launches
    out = pass2_min_cuda(torch.full((10 + 2 * k, 16), 1.0e30, device=dev),
                         zeros(10, 2 * k + 1), zeros(10, 2 * k + 1), k)
    torch.cuda.synchronize()
    assert pass2_min_cuda.launches == p0 + 1 and (out == 1.0e30).all()
    p0 += 1
    h, w, nn = 8, 8, ring_limits()[1] + 1     # B1: past its widest radius
    params = Params()
    scan = StackedScan(h, w, params, dev)
    bufs = scan.init_buffers(1, zeros(h, w), zeros(h, w))
    with pytest.raises(ValueError, match=f"NN <= {nn - 1}"):
        ring_trigger_cuda_stacked(
            zeros(h + 2 * nn, w + 2 * nn), zeros(h + 2 * nn, w + 2 * nn),
            zeros(h, w), zeros(h, w), zeros(h, w), zeros(h, w), zeros(h, w),
            False, False, params, nn, 0, *bufs, scan.ever)
    assert pass2_min_cuda.launches == p0
    assert ring_trigger_cuda_stacked.launches == r0
    out = pass2_min_cuda(torch.full((14, 16), 1.0e30, device=dev),
                         zeros(10, 5), zeros(10, 5), 2)
    torch.cuda.synchronize()
    assert pass2_min_cuda.launches == p0 + 1
    assert (out == 1.0e30).all()


@pytest.mark.cuda
def test_new_launchers_reject_oversized_shared_memory(dev):
    """B3 one past the widest radius its shared memory holds
    (``min_haversine_limits``, 354) and at 1000 runs its large build,
    bit-equal to plain (it once raised ``ValueError`` there); B4/B5 at NN
    = 2048, past theirs: each wrapper raises ``ValueError`` naming the
    limit before launching and counts no launch; the next good launch is
    not blamed.  (Since the ring kernels take NN past 2047, B4/B5's limit
    is ``ring_limits``' 23169, the int32 integral image's.)"""
    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    counts = lambda: (min_haversine_param_cuda.launches,  # noqa: E731
                      ring_trigger_cuda_padded.launches,
                      ring_thc_cuda_padded.launches)
    max_k = min_haversine_limits()
    assert max_k == 354
    rng = np.random.default_rng(0)
    for k in (max_k + 1, 1000):
        h, w = 10, 16
        cpad = torch.as_tensor((rng.random((h + 2 * k, w + 2 * k)) < 0.01)
                               .astype(np.float32), device=dev)
        tabs = [torch.as_tensor(rng.random((n, 2 * k + 1), np.float32),
                                device=dev) for n in (h, h, w)]
        before = counts()[0]
        got = min_haversine_param_cuda(cpad, *tabs, k)
        assert counts()[0] == before + 1
        torch.testing.assert_close(
            got, min_haversine_param_from_padded(cpad, *tabs, k), rtol=0,
            atol=0)
    before = counts()
    h, w, nn = 8, 8, ring_limits()[1] + 1     # B4, B5: past the limit
    pads = (zeros(h + 2 * nn, w + 2 * nn), zeros(h + 2 * nn, w + 2 * nn))
    with pytest.raises(ValueError, match=f"NN <= {nn - 1}"):
        ring_trigger_cuda_padded(*pads, *(zeros(h, w) for _ in range(5)),
                                 False, False, Params(), nn)
    with pytest.raises(ValueError, match=f"NN <= {nn - 1}"):
        ring_thc_cuda_padded(*pads, zeros(h, w), nn)
    assert counts() == before
    k = 2
    out = min_haversine_param_cuda(zeros(10 + 2 * k, 16 + 2 * k),
                                   zeros(10, 5), zeros(10, 5), zeros(16, 5), k)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1,) + before[1:]
    assert (out == 1.0e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("radius", ["k", "zero"])
def test_min_haversine_kernel_bit_equal_to_plain(name, radius, dev):
    """B3 against its plain version, bit for bit, at the grid's k and at
    k = 0 (a one-tap window), with the tables' monotone flags and without
    them (the kernel's loop over the set coast bits); and against the
    hybrid (torch pass 1 + B2)."""
    grid, (lsm, *_, ci) = _world(name)
    k = TriggerPipeline(grid, device=dev).k if radius == "k" else 0
    tabs = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci[1], device=dev))
    cpad = pad_coast(coast, k)
    ref = min_haversine_param_from_padded(cpad, *tabs, k)
    for mono in (tabs.monotone, None):
        before = min_haversine_param_cuda.launches
        got = min_haversine_param_cuda(cpad, *tabs, k, monotone=mono)
        assert min_haversine_param_cuda.launches == before + 1
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(
        got, pass2_min_cuda(pass1_extrema(cpad, tabs[2], k)[0], tabs[0],
                            tabs[1], k), rtol=0, atol=0)


#: B3's radii: the small builds' (0, 1, 6, 15), the last and first k the
#: first design's shared memory held and refused (88, 89), the fine and
#: 1 km worlds' (93, 155), a 0.5 km grid's at 54 N (310), and the large
#: build's: one past the widest the shared-memory builds hold (355, which
#: the kernel once refused), a 0.4 km grid's at 54 N (387), 620 and 1000;
#: the widest of the shared-memory builds is added in the test.
B3_RADII = (0, 1, 6, 15, 88, 89, 93, 155, 310, 355, 387, 620, 1000)
#: name -> (nlat, nlon, global lon axis, coast): a field smaller than one
#: band (10 x 20), exactly one band of 32 columns, a ragged band edge
#: (37 x 70), a row pitch no multiple of 16 bytes with the field starting
#: one float past a 16-byte boundary (21 x 45), the periodic seam with
#: coast in both edge columns, no coast, all coast, and one coast cell at
#: each corner of the 32-column bands.
B3_CASES = {
    "subtile": (10, 20, True, "random"),
    "one_band": (24, 32, False, "random"),
    "ragged": (37, 70, False, "random"),
    "misaligned": (21, 45, True, "random"),
    "seam": (30, 64, True, "seam"),
    "none": (17, 40, True, "none"),
    "all": (17, 40, False, "all"),
    "corners": (33, 96, False, "corners"),
}


def _b3_coast(nlat, nlon, kind, rng):
    c = np.zeros((nlat, nlon), np.float32)
    if kind == "random":
        c[rng.random((nlat, nlon)) < 0.04] = 1.0
    elif kind == "seam":
        c[nlat // 3, 0] = c[2 * nlat // 3, nlon - 1] = 1.0
    elif kind == "all":
        c[:] = 1.0
    elif kind == "corners":
        for x in range(0, nlon, 32):
            for y, xx in ((0, x), (0, x + 31), (nlat - 1, x),
                          (nlat - 1, x + 31), (nlat // 2, x + 31)):
                c[y, min(xx, nlon - 1)] = 1.0
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B3_CASES))
@pytest.mark.parametrize("k", B3_RADII + ("max",))
def test_min_haversine_every_radius(case, k, dev):
    """B3 bit-equal to its plain version at every radius, its
    shared-memory builds up to their widest (the first design refused k >=
    89) and its large build past it (once refused), on sub-band, one-band,
    ragged and misaligned fields, the periodic seam, no coast, all coast
    and coast at the band corners.  Three tables each: a grid's with its
    monotone flags (pass 1 by the nearest coast bit each side, bar a
    regional grid's columns within k of its seam) and its rows' flags (the
    large build's early exit in pass 2), the same without either or both,
    and a random table that has the property nowhere (its flags all
    zero)."""
    k = min_haversine_limits() if k == "max" else k
    nlat, nlon, glob, kind = B3_CASES[case]
    rng = np.random.default_rng(k)
    lat = np.linspace(60.0, 20.0, nlat).astype(np.float32)
    lon = (np.arange(nlon) * (360.0 / nlon if glob else 0.02)).astype(
        np.float32)
    tabs = device_tables(Grid(lon=lon, lat=lat), k, dev)
    noisy = [torch.as_tensor(rng.random((n, 2 * k + 1), np.float32),
                             device=dev) for n in (nlat, nlat, nlon)]
    rough = DistanceTables(*noisy, *(torch.as_tensor(window_monotone(
        noisy[i].cpu().numpy(), k).astype(np.uint8), device=dev)
        for i in (2, 0)))
    assert k < 2 or not (rough.monotone.any() or rough.row_monotone.any())
    assert bool(tabs.row_monotone.all())
    coast = torch.as_tensor(_b3_coast(nlat, nlon, kind, rng), device=dev)
    cpad = pad_coast(coast, k)
    if case == "misaligned":
        flat = torch.empty(cpad.numel() + 1, device=dev)
        flat[1:] = cpad.reshape(-1)
        cpad = flat[1:].view(cpad.shape)
        assert cpad.data_ptr() % 16 == 4 and cpad.shape[1] % 4 != 0
    for t, mono, rows in ((tabs, tabs.monotone, tabs.row_monotone),
                          (tabs, tabs.monotone, None),
                          (tabs, None, tabs.row_monotone), (tabs, None, None),
                          (rough, rough.monotone, rough.row_monotone)):
        before = min_haversine_param_cuda.launches
        got = min_haversine_param_cuda(cpad, *t, k, monotone=mono,
                                       row_monotone=rows)
        assert min_haversine_param_cuda.launches == before + 1
        torch.testing.assert_close(
            got, min_haversine_param_from_padded(cpad, *t, k), rtol=0,
            atol=0)


#: Fields where the wide-radius pass 2's early exit matters, at radius k:
#: name -> (nlat, nlon, global lon axis, coast cells or a density).
#: ``far_edge``: one coast cell k rows below row 0 (row 0's last lat tap
#: centre-out); ``far_corner``: one cell k rows and k columns from cell
#: (0, 0), the corner of its window; ``lane_out``: one cell, in a field
#: wider than 2k+1 columns that is no multiple of 32, so the columns
#: farther than k from it (both ways round the periodic pad) sit in warps
#: whose other lanes have coast; ``lat_edges``: every row within k of both
#: lat edges; ``seam``: a regional grid (its columns within k of the seam
#: not monotone) with coast in both edge columns; ``none``: no coast;
#: ``ragged``: 45 columns; ``segments``: 4100 columns, more than one pass-1
#: block of B3's large build takes (4096), so a row is split.
def _wide_field(kind, k, rng):
    if kind == "far_edge":
        h, w, glob, cells = k + 4, 40, True, [(k, 7)]
    elif kind == "far_corner":
        h, w, glob, cells = k + 1, 2 * k + 2, True, [(k, k)]
    elif kind == "lane_out":
        h, w, glob, cells = 8, 2 * k + 40, True, [(3, 0)]
    elif kind == "seam":
        h, w, glob, cells = 30, 96, False, [(5, 0), (20, 95)]
    elif kind == "none":
        h, w, glob, cells = 17, 40, True, []
    else:
        h, w, glob = {"lat_edges": (40, 70, True), "ragged": (24, 45, False),
                      "segments": (6, 4100, False)}[kind]
        cells = list(zip(*np.nonzero(rng.random((h, w)) < 0.04)))
    c = np.zeros((h, w), np.float32)
    for y, x in cells:
        c[y, x] = 1.0
    lat = np.linspace(60.0, 20.0, h).astype(np.float32)
    lon = (np.arange(w) * (360.0 / w if glob else 0.02)).astype(np.float32)
    return Grid(lon=lon, lat=lat), c


WIDE_FIELDS = ("far_edge", "far_corner", "lane_out", "lat_edges", "seam",
               "none", "ragged", "segments")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WIDE_FIELDS)
@pytest.mark.parametrize("k", [176, 310, 355, 387, 620, 1000])
def test_wide_radius_fields_bit_equal_to_plain(kind, k, dev):
    """B3 (its large build past 354) and B2 (its unstaged build past 175)
    bit-equal to their plain versions on the fields where the early exit of
    their pass 2 matters (``_wide_field``), with the rows' flags and
    without; and on the grid's tables every row has the flag."""
    grid, c = _wide_field(kind, k, np.random.default_rng(k))
    tabs = device_tables(grid, k, dev)
    assert bool(tabs.row_monotone.all())
    cpad = pad_coast(torch.as_tensor(c, device=dev), k)
    ref = min_haversine_param_from_padded(cpad, *tabs, k)
    if kind == "lane_out":
        reach = (ref < 0.5e30).any(dim=0).cpu().numpy()
        assert reach.any() and not reach.all()
    mmin, _ = pass1_extrema(cpad, tabs[2], k)
    for rows in (tabs.row_monotone, None):
        before = (min_haversine_param_cuda.launches, pass2_min_cuda.launches)
        got3 = min_haversine_param_cuda(cpad, *tabs, k,
                                        monotone=tabs.monotone,
                                        row_monotone=rows)
        got2 = pass2_min_cuda(mmin, tabs[0], tabs[1], k, row_monotone=rows)
        assert (min_haversine_param_cuda.launches,
                pass2_min_cuda.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got3, ref, rtol=0, atol=0)
        torch.testing.assert_close(got2, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WIDE_FIELDS)
def test_pass2_two_extremum_exit_on_grid_tables(kind, dev):
    """B2's two-extremum form at k = 387 (its pruned build) on pass 1's
    extrema of the wide-radius fields (``_wide_field``) with the grid's own
    tables (po >= 0): bit-equal to the single form, whose function it then
    computes, and to its plain version.  There its exit fires: in the host
    model of its schedule (``tools/pruned_model.py::pass2_two_centre_out``,
    bit-equal too) no warp takes more taps than in the single form's
    schedule with the rows' flags, and the warps take fewer than every tap
    wherever the field has coast."""
    k = 387
    assert k > pass2_min_two_limits()
    grid, c = _wide_field(kind, k, np.random.default_rng(k))
    tabs = device_tables(grid, k, dev)
    cpad = pad_coast(torch.as_tensor(c, device=dev), k)
    mmin, mmax = pass1_extrema(cpad, tabs[2], k, need_max=True)
    sdphi2, po, _ = tabs
    assert bool((po >= 0).all())
    ref = pass2_min(mmin, sdphi2, po, k, Mmax=mmax)
    single = pass2_min_cuda(mmin, sdphi2, po, k,
                            row_monotone=tabs.row_monotone)
    torch.testing.assert_close(single, ref, rtol=0, atol=0)
    got = pass2_min_two_cuda(mmin, mmax, sdphi2, po, k)
    assert torch.equal(got.view(torch.int32), single.view(torch.int32))
    h_args = [a.cpu().numpy() for a in (mmin, mmax, sdphi2, po)]
    amin, taps = pass2_two_centre_out(*h_args, k)
    np.testing.assert_array_equal(amin, got.cpu().numpy())
    _, one = pass2_centre_out(h_args[0], *h_args[2:], k,
                              tabs.row_monotone.cpu().numpy(), band=64)
    assert (taps <= one).all()
    if c.any():
        assert taps.mean() < 2 * 8 * -(-(k + 1) // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_ring_padded_kernels_bit_equal_to_plain(name, tt, dev):
    """B4 (sb and the new wind state) and B5 (n_thc) against their plain
    versions, bit for bit, across seeding (1), a plain step (5) and a
    refresh (15); B4 leaves its inputs alone."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    params = Params()
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pipe = TriggerPipeline(grid, device=dev)
    nn = pipe.nn_max + 4
    cd = pipe.distance_field(D(lsm), D(ci[1]))
    t0, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[1]), D(u[1]), D(v[1]), cd, D(z), D(std), D(pres), params, nn)
    rng = np.random.default_rng(tt)
    ws0 = D((5 + rng.random(lsm.shape)).astype(np.float32))
    wd0 = D((360 * rng.random(lsm.shape) - 180).astype(np.float32))
    keep = ws0.clone()
    is_first, upd = cadence(tt, params)
    before = ring_trigger_cuda_padded.launches
    got = ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new, wd_new, ws0,
                                   wd0, is_first, upd, params, nn)
    assert ring_trigger_cuda_padded.launches == before + 1
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                        is_first, upd, params, nn)
    for g, want in zip(got, (ref[0], ref[3], ref[4])):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    torch.testing.assert_close(ws0, keep, rtol=0, atol=0)

    before = ring_thc_cuda_padded.launches
    n_thc = ring_thc_cuda_padded(t0_pad, cd_pad, cd, nn)
    assert ring_thc_cuda_padded.launches == before + 1
    coastal = cd.abs() <= 180.0
    want, _ = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                                   torch.where(cd >= 0, 1.0, -1.0), nn,
                                   coastal=coastal)
    torch.testing.assert_close(n_thc, want, rtol=0, atol=0)
    assert (n_thc[~coastal] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_coupled_paths_match_plain(name, dev):
    """Three coupled steps from tt=14 (prepare_mask + physics, 3-D
    pressure) and three ``TriggerPipeline.step`` calls: kernel path
    against plain path, per-step fields within 2e-5/2e-4, wind state
    bit-equal, B4 once per step.  The fused distance (B3, the default)
    gives the hybrid's (torch pass 1 + B2) bit for bit, and a fused
    ``run`` the hybrid run's outputs."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    rng = np.random.default_rng(2)
    p3 = (pres[:, None, None] * (1.0 + 0.3 * rng.random(
        (1,) + lsm.shape))).astype(np.float32)
    ws = (5 + rng.random(lsm.shape)).astype(np.float32)
    runs = {}
    for uk in (None, False):
        ct = CoupledTrigger(grid, use_kernels=uk, device=dev)
        pipe = TriggerPipeline(grid, device=dev, use_kernels=uk)
        st_c = st_p = TriggerState(14, *(torch.as_tensor(a, device=dev)
                                         for a in (ws, ws, -ws)))
        b4 = ring_trigger_cuda_padded.launches
        outs = []
        for t in range(3):
            cd = ct.prepare_mask(lsm, ci[t])
            st_c, oc = ct.physics(st_c, p3, u[t], v[t], theta[t], z, std, cd)
            st_p, op = pipe.step(st_p, theta[t], u[t], v[t], lsm, z, std,
                                 pres, ci=ci[t])
            outs.append((oc, op))
        assert ring_trigger_cuda_padded.launches - b4 == (6 if uk is None
                                                           else 0)
        runs[uk] = (outs, st_c, st_p)
    for (kc, kp), (pc, pp) in zip(runs[None][0], runs[False][0]):
        for key in pc:
            _close(kc[key], pc[key], key)
            _close(kp[key], pp[key], key)
    for i in (1, 2):
        for key in ("windspeed", "winddir"):
            torch.testing.assert_close(getattr(runs[None][i], key),
                                       getattr(runs[False][i], key), rtol=0,
                                       atol=0)

    fused = TriggerPipeline(grid, device=dev)
    hybrid = TriggerPipeline(grid, device=dev, distance_impl="hybrid")
    lsm_d, ci_d = torch.as_tensor(lsm, device=dev), torch.as_tensor(
        ci, device=dev)
    torch.testing.assert_close(fused.distance_field(lsm_d, ci_d[1]),
                               hybrid.distance_field(lsm_d, ci_d[1]),
                               rtol=0, atol=0)
    b3, b2 = min_haversine_param_cuda.launches, pass2_min_cuda.launches
    fin = [p.run(TriggerState.zeros(lsm.shape, dev), theta, u, v, lsm, z,
                 std, pres, ci_t=ci) for p in (fused, hybrid)]
    assert min_haversine_param_cuda.launches - b3 == len(ci)
    assert pass2_min_cuda.launches - b2 == len(ci)
    for key in fin[1][1]:
        torch.testing.assert_close(fin[0][1][key], fin[1][1][key], rtol=0,
                                   atol=0)


#: name -> (mesh shape, field shape): ragged shards (37 x 35: a width no
#: multiple of 4, so rows start at every offset modulo 16 bytes), 1-wide
#: mesh axes, one shard, 64 shards (8 x 11).
HALO_MESHES = {
    "2x4": ((2, 4), (74, 140)),
    "3x3": ((3, 3), (33, 99)),
    "1x7": ((1, 7), (30, 84)),
    "5x1": ((5, 1), (55, 40)),
    "1x1": ((1, 1), (37, 70)),
    "8x8": ((8, 8), (64, 88)),
}
#: Every (lat_fill, exact_lon).
HALO_FILLS = [("clamp", True), ("clamp", False), ("zero", False),
              ("zero", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(HALO_MESHES))
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_bit_equal_to_plain(name, lat_fill, exact_lon, channels,
                                        dev):
    """B6 against its plain version, bit for bit, one launch per exchange,
    at no, 1-wide, uneven, one-sided and full-shard widths."""
    (py, px), (nlat, nlon) = HALO_MESHES[name]
    mesh = make_mesh((py, px), dev)
    shape = (channels, nlat, nlon) if channels > 1 else (nlat, nlon)
    field = np.random.default_rng(7).standard_normal(shape)
    local = split(torch.as_tensor(field.astype(np.float32), device=dev),
                  mesh)
    h, w = nlat // py, nlon // px
    for hy, hx in ((0, 0), (1, 1), (3, 2), (0, 2), (2, 0),
                   (h, w - 1 if exact_lon else w)):
        kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
        before = halo_exchange_cuda.launches
        got = halo_exchange_cuda(local, mesh, hy, hx, **kw)
        assert halo_exchange_cuda.launches == before + 1
        want = halo_exchange_plain(local, mesh, hy, hx, **kw)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_process_edges_bit_equal_to_plain(rank, lat_fill,
                                                      exact_lon, channels,
                                                      dev):
    """B6 with a process edge's rows (its third fill, the strips of a
    multi-process run) against its plain version and against the exchange
    of the whole mesh on one process, bit for bit: rank ``rank``'s block
    of a 6 x 3 mesh (15 columns a shard, so rows start at every offset
    modulo 16 bytes) split over three processes, one launch per
    exchange."""
    from tests.test_torch_multihost import process_block
    shape = (channels, 72, 45) if channels > 1 else (72, 45)
    field = torch.as_tensor(np.random.default_rng(rank).standard_normal(
        shape).astype(np.float32), device=dev)
    one = make_mesh((6, 3), dev)
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    for hy, hx in ((1, 1), (3, 2), (0, 2), (2, 0),
                   (12, 14 if exact_lon else 15)):
        local, mesh, edges = process_block(field, (6, 3), 3, rank, hy, dev)
        before = halo_exchange_cuda.launches
        got = halo_exchange_cuda(local, mesh, hy, hx, edges=edges, **kw)
        assert halo_exchange_cuda.launches == before + 1
        plain = halo_exchange_plain(local, mesh, hy, hx, edges=edges, **kw)
        whole = halo_exchange_plain(split(field, one), one, hy, hx,
                                    **kw)[rank * 6:(rank + 1) * 6]
        for g, p, r in zip(got, plain, whole):
            torch.testing.assert_close(g, p, rtol=0, atol=0)
            torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 1, 6, 10, 17, 15, 19, 35, 40])
@pytest.mark.parametrize("w", [44, 45])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_path_widths_bit_equal_to_plain(width, w, offset,
                                                    lat_fill, exact_lon,
                                                    channels, dev):
    """B6 against its plain version, bit for bit, on 2 x 4 shards of 40 x w
    at the decomposed run's widths — k, NN and NN + k + 1 at 0.25 deg (6,
    10, 17) and 0.1 deg (15, 19, 35) — and at 0, 1 and h; w = 44 keeps the
    source rows 16-byte aligned, 45 does not; ``offset`` 1 starts every
    shard one float past a 16-byte boundary (shards that are views into
    one buffer), so source and destination differ in alignment."""
    mesh = make_mesh((2, 4), dev)
    h = 40
    shape = (channels, h, w) if channels > 1 else (h, w)
    n = int(np.prod(shape))
    rng = np.random.default_rng(width * 100 + w)
    buf = torch.as_tensor(rng.standard_normal(offset + 8 * n).astype(
        np.float32), device=dev)
    local = [buf[offset + s * n: offset + (s + 1) * n].view(shape)
             for s in range(8)]
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    before = halo_exchange_cuda.launches
    got = halo_exchange_cuda(local, mesh, width, width, **kw)
    assert halo_exchange_cuda.launches == before + 1
    for g, r in zip(got, halo_exchange_plain(local, mesh, width, width,
                                             **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
def test_halo_kernel_refusals(dev):
    """B6 refuses a halo wider than the shard, other dtypes, non-contiguous
    or off-device shards, other ranks and more shards than one launch
    takes, and counts no launch; 64 shards are one launch."""
    mesh = make_mesh((2, 2), dev)
    local = split(torch.zeros(8, 12, device=dev), mesh)
    before = halo_exchange_cuda.launches
    with pytest.raises(ValueError, match="wider than"):
        halo_exchange_cuda(local, mesh, 5, 1)
    with pytest.raises(ValueError, match="dtype"):
        halo_exchange_cuda([x.double() for x in local], mesh, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        halo_exchange_cuda([torch.zeros(6, 4, device=dev).t()] * 4, mesh,
                           1, 1)
    with pytest.raises(ValueError, match="on cpu"):
        halo_exchange_cuda(local[:3] + [local[3].cpu()], mesh, 1, 1)
    with pytest.raises(ValueError, match=r"\(h, w\) or \(C, h, w\)"):
        halo_exchange_cuda([x[None, None] for x in local], mesh, 1, 1)
    with pytest.raises(ValueError, match="at most 64"):
        halo_exchange_cuda([torch.zeros(2, 1, device=dev)] * 65,
                           ShardMesh(1, 65, mesh.device), 0, 0)
    assert halo_exchange_cuda.launches == before
    big = ShardMesh(8, 8, mesh.device)
    field = torch.arange(16 * 24, dtype=torch.float32,
                         device=dev).reshape(16, 24)
    got = halo_exchange_cuda(split(field, big), big, 2, 3)
    want = halo_exchange_plain(split(field, big), big, 2, 3)
    assert halo_exchange_cuda.launches == before + 1
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("row_offset,extra", [(5, 0), (3, 10), (4, -2)])
def test_ring_kernels_with_row_offset_match_plain(name, row_offset, extra,
                                                  dev):
    """B4 (bit for bit) and B1 (slot within 2e-5/2e-4, state bit-equal) on
    a block whose first row is global row ``row_offset`` of a grid of
    ``row_offset + h + extra`` rows: the grid's last row inside the block
    (0), beyond it (10), or padding rows at its end (-2)."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    params = Params()
    D = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pipe = TriggerPipeline(grid, device=dev)
    nn = pipe.nn_max
    cd = pipe.distance_field(D(lsm), D(ci[1]))
    _, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        D(theta[1]), D(u[1]), D(v[1]), cd, D(z), D(std), D(pres), params, nn)
    rng = np.random.default_rng(3)
    ws0 = D((5 + rng.random(lsm.shape)).astype(np.float32))
    wd0 = D((360 * rng.random(lsm.shape) - 180).astype(np.float32))
    flags = cadence(15, params)
    rows = dict(row_offset=row_offset,
                nlat_total=row_offset + lsm.shape[0] + extra)
    ref = trigger_cells(cd, ws_new, wd_new, ws0, wd0, t0_pad, cd_pad,
                        *flags, params, nn, **rows)
    got = ring_trigger_cuda_padded(t0_pad, cd_pad, cd, ws_new, wd_new, ws0,
                                   wd0, *flags, params, nn, **rows)
    for g, want in zip(got, (ref[0], ref[3], ref[4])):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    scan = StackedScan(*lsm.shape, params, dev)
    bufs = scan.init_buffers(1, ws0, wd0, **rows)
    ws_s, wd_s = ws0.clone(), wd0.clone()
    ring_trigger_cuda_stacked(t0_pad, cd_pad, cd, ws_new, wd_new, ws_s, wd_s,
                              *flags, params, nn, 0, *bufs,
                              scan.add_coastal(cd), **rows)
    for b, want, what in zip(bufs, ref, ("sb", "ws", "wd")):
        _close(b[0], want, what)
    torch.testing.assert_close(ws_s, ref[3], rtol=0, atol=0)
    torch.testing.assert_close(wd_s, ref[4], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (3, 2)])
def test_sharded_kernel_path_matches_plain(mesh_shape, dev):
    """``ShardedPipeline.run`` on the card, three steps from tt = 14 with
    ice appearing at step 1 (3 x 2 pads 121 lat rows to 123): the kernel
    path (B6 + B2 + B1) against the plain path, per-step fields within
    2e-5/2e-4 and final wind bit-equal; basic (B6 + B2 + B4) bit-equal to
    overlapped; one B6 launch per exchange, none on the plain path."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world("global121")
    mesh = make_mesh(mesh_shape, dev)
    rng = np.random.default_rng(0)
    ws = (5 + rng.random(lsm.shape)).astype(np.float32)
    state = TriggerState(14, *(torch.as_tensor(a, device=dev)
                               for a in (np.zeros_like(ws), ws, -ws)))
    runs, b6 = {}, {}
    for label, uk, overlap in (("overlap", None, True), ("basic", None, False),
                               ("plain", False, True)):
        sp = ShardedPipeline(TriggerPipeline(grid, device=dev,
                                             use_kernels=uk), mesh,
                             overlap=overlap)
        before = halo_exchange_cuda.launches
        runs[label] = sp.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        b6[label] = halo_exchange_cuda.launches - before
    T = len(theta)
    assert b6 == {"overlap": 3 + 2 * T, "basic": 3 * T, "plain": 0}
    (ks, ko), (bs, bo), (ps, po) = (runs[x] for x in ("overlap", "basic",
                                                      "plain"))
    for key in po:
        _close(ko[key], po[key], key)
        torch.testing.assert_close(bo[key], ko[key], rtol=0, atol=0)
    for f in ("windspeed", "winddir"):
        torch.testing.assert_close(getattr(ks, f), getattr(ps, f), rtol=0,
                                   atol=0)
        torch.testing.assert_close(getattr(bs, f), getattr(ks, f), rtol=0,
                                   atol=0)
    assert ko["sb_con"].shape == (T,) + lsm.shape


#: (mesh shape, field shape, groups) of the grouped exchanges: one card
#: named once per group, so the cross-group code runs on one card.
GROUPED_HALO = [((2, 2), (74, 140), 2), ((2, 2), (74, 140), 4),
                ((2, 4), (74, 140), 4), ((1, 4), (30, 84), 2),
                ((4, 1), (56, 45), 4), ((3, 3), (33, 99), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(GROUPED_HALO)))
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_groups_bit_equal_to_plain(case, lat_fill, exact_lon,
                                               channels, dev):
    """B6 over a mesh of several groups on one card, one launch per group
    on the group's stream, against its plain version and the one-group
    launch, bit for bit, at no, 1-wide, uneven and full-shard widths."""
    (py, px), (nlat, nlon), groups = GROUPED_HALO[case]
    mesh = make_mesh((py, px), [dev] * groups)
    one = make_mesh((py, px), dev)
    assert mesh.groups == groups and one.groups == 1
    shape = (channels, nlat, nlon) if channels > 1 else (nlat, nlon)
    field = torch.as_tensor(np.random.default_rng(case).standard_normal(
        shape).astype(np.float32), device=dev)
    local = split(field, mesh)
    h, w = nlat // py, nlon // px
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    for hy, hx in ((0, 0), (1, 1), (3, 2), (h, w - 1 if exact_lon else w)):
        before = halo_exchange_cuda.launches
        got = halo_exchange_cuda(local, mesh, hy, hx, **kw)
        assert halo_exchange_cuda.launches == before + groups
        want = halo_exchange_plain(local, mesh, hy, hx, **kw)
        ref = halo_exchange_cuda(local, one, hy, hx, **kw)
        for g, p, r in zip(got, want, ref):
            torch.testing.assert_close(g, p, rtol=0, atol=0)
            torch.testing.assert_close(g, r, rtol=0, atol=0)


def _grouped_runs(mesh, one, reps):
    """``ShardedPipeline`` on the global121 world over ``mesh`` ``reps``
    times and over ``one`` once, both structures; every grouped run is
    held bit-equal to the one-group run, and its B6 launches counted."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world("global121")
    rng = np.random.default_rng(0)
    ws = (5 + rng.random(lsm.shape)).astype(np.float32)
    state = TriggerState(14, *(torch.as_tensor(a, device=one.device)
                               for a in (np.zeros_like(ws), ws, -ws)))
    T = len(theta)
    for overlap in (True, False):
        pipe = TriggerPipeline(grid, device=one.device)
        ref = ShardedPipeline(pipe, one, overlap=overlap).run(
            state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        sp = ShardedPipeline(pipe, mesh, overlap=overlap)
        assert sp.overlap is overlap
        for rep in range(reps):
            before = halo_exchange_cuda.launches
            got = sp.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
            exchanges = 3 + 2 * T if overlap else 3 * T
            assert (halo_exchange_cuda.launches - before
                    == mesh.groups * exchanges)
            for key in ref[1]:
                torch.testing.assert_close(got[1][key], ref[1][key], rtol=0,
                                           atol=0, msg=f"{key} rep {rep}")
            for f in ("thc", "windspeed", "winddir"):
                torch.testing.assert_close(getattr(got[0], f),
                                           getattr(ref[0], f), rtol=0,
                                           atol=0, msg=f"{f} rep {rep}")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 4])
def test_sharded_groups_on_one_card_bit_equal_repeated(groups, dev):
    """2 x 2 shards in ``groups`` groups on one card, each group on its own
    stream (B6 per group + B2 + B1, basic B4), 20 runs in a row, each
    bit-equal to the one-group mesh: a source shard is neither rewritten
    nor reused by its owner before its readers have read it."""
    _grouped_runs(make_mesh((2, 2), [dev] * groups), make_mesh((2, 2), dev),
                  reps=20)


#: (global mesh, processes, rank, groups of the rank's block) of the
#: grouped exchanges with process edges: a 2 x 3 block in 2 groups (a
#: mesh row each), in 3 (two shards each, the middle group across both
#: rows, so it reads both edges) and in 6; a 1 x 4 block, one mesh row
#: across 2 and 4 groups (each reads both edges).
GROUPED_EDGES = [((6, 3), 3, 1, 2), ((6, 3), 3, 1, 3), ((6, 3), 3, 0, 6),
                 ((6, 3), 3, 2, 3), ((3, 4), 3, 1, 2), ((3, 4), 3, 1, 4)]


def _edge_exchanges(field, global_shape, world, rank, devices, kw):
    """B6 over ``rank``'s block of ``global_shape`` split over ``world``
    processes, the block over ``devices``, fed the process edges as
    ``exchange_edges`` delivers them: at 1-wide, uneven, one-sided and
    full-shard widths, one launch per group, each held bit-equal to its
    plain version, to one group a process and to the exchange of the whole
    mesh on one process."""
    from tests.test_torch_multihost import process_block
    py, px = global_shape
    h, w = field.shape[-2] // py, field.shape[-1] // px
    one = make_mesh(global_shape, devices[0])
    for hy, hx in ((1, 1), (3, 2), (0, 2), (2, 0),
                   (h, w - 1 if kw["exact_lon"] else w)):
        local, mesh, edges = process_block(field, global_shape, world, rank,
                                           hy, devices[0], devices)
        flat, fmesh, fedges = process_block(field, global_shape, world,
                                            rank, hy, devices[0])
        assert mesh.groups == len(devices) and fmesh.groups == 1
        before = halo_exchange_cuda.launches
        got = halo_exchange_cuda(local, mesh, hy, hx, edges=edges, **kw)
        assert halo_exchange_cuda.launches == before + mesh.groups
        plain = halo_exchange_plain(local, mesh, hy, hx, edges=edges, **kw)
        ref = halo_exchange_cuda(flat, fmesh, hy, hx, edges=fedges, **kw)
        whole = halo_exchange_plain(split(field, one), one, hy, hx, **kw)[
            rank * mesh.size:(rank + 1) * mesh.size]
        for s, (g, p, f, r) in enumerate(zip(got, plain, ref, whole)):
            assert g.device == mesh.device_of(s)
            torch.testing.assert_close(g, p, rtol=0, atol=0)
            torch.testing.assert_close(g.to(f.device), f, rtol=0, atol=0)
            torch.testing.assert_close(g.to(r.device), r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(GROUPED_EDGES)))
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_process_edges_groups_bit_equal_to_plain(
        case, lat_fill, exact_lon, channels, dev):
    """B6 over a process's block in 2-6 groups of one card, each group's
    launch given the process edges it reads (none where its shards do not
    touch the block's first or last mesh row), 15 columns a shard so rows
    start at every offset modulo 16 bytes (:func:`_edge_exchanges`)."""
    global_shape, world, rank, groups = GROUPED_EDGES[case]
    shape = (72, 15 * global_shape[1])
    if channels > 1:
        shape = (channels,) + shape
    field = torch.as_tensor(np.random.default_rng(case).standard_normal(
        shape).astype(np.float32), device=dev)
    _edge_exchanges(field, global_shape, world, rank, [dev] * groups,
                    dict(lat_fill=lat_fill, exact_lon=exact_lon))


@pytest.mark.cuda
def test_halo_kernel_refuses_process_edges_off_the_groups_card(dev):
    """A group whose process edge has no copy on its card, or whose copy
    lies on another device, is refused: B6 never reads an edge from
    another card and never falls back to the plain version."""
    from tests.test_torch_multihost import process_block
    field = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (72, 45)).astype(np.float32), device=dev)
    local, mesh, edges = process_block(field, (6, 3), 3, 1, 2, dev,
                                       [dev] * 2)
    (top, bot), = edges.values()
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="no copy on its device"):
        halo_exchange_cuda(local, mesh, 2, 2,
                           edges={cpu: (top.to(cpu), bot.to(cpu))})
    with pytest.raises(ValueError, match="group 0's top edge: on cpu"):
        halo_exchange_cuda(local, mesh, 2, 2,
                           edges={mesh.device: (top.to(cpu), bot)})


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the peer path across cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
def test_halo_kernel_across_cards_bit_equal_to_plain(lat_fill, exact_lon,
                                                     two_cards):
    """B6 over a 2 x 2 mesh on two cards (and four groups on them), the
    launches reading the other card's shards through peer pointers, bit
    for bit against the plain version and the one-card launch."""
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    field = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 74, 140)).astype(np.float32), device=two_cards[0])
    one = make_mesh((2, 2), two_cards[0])
    for devices in (two_cards, two_cards * 2):
        mesh = make_mesh((2, 2), devices)
        local = split(field, mesh)
        assert {x.device for x in local} == set(two_cards)
        for hy, hx in ((1, 1), (3, 2), (37, 34 if exact_lon else 35)):
            got = halo_exchange_cuda(local, mesh, hy, hx, **kw)
            want = halo_exchange_plain(local, mesh, hy, hx, **kw)
            ref = halo_exchange_cuda(split(field, one), one, hy, hx, **kw)
            for s, (g, p, r) in enumerate(zip(got, want, ref)):
                assert g.device == mesh.device_of(s)
                torch.testing.assert_close(g, p, rtol=0, atol=0)
                torch.testing.assert_close(g.to(r.device), r, rtol=0, atol=0)


@pytest.mark.cuda
def test_sharded_across_cards_bit_equal_repeated(two_cards):
    """2 x 2 shards on two cards, both structures, 20 runs in a row, each
    bit-equal to the one-group mesh on the first card."""
    _grouped_runs(make_mesh((2, 2), two_cards),
                  make_mesh((2, 2), two_cards[0]), reps=20)


@pytest.mark.cuda
@pytest.mark.parametrize("lat_fill,exact_lon", HALO_FILLS)
def test_halo_kernel_process_edges_across_cards_bit_equal_to_plain(
        lat_fill, exact_lon, two_cards):
    """A process's block over two cards (and over four groups on them),
    each group's launch taking the process edges' copy on its own card
    (:func:`_edge_exchanges`): a 2 x 4 block, a mesh row on each card, and
    a 1 x 4 block, one mesh row across both cards."""
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    for global_shape in ((6, 4), (3, 4)):
        field = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (2, 72, 60)).astype(np.float32), device=two_cards[0])
        for devices in (two_cards, two_cards * 2):
            _edge_exchanges(field, global_shape, 3, 1, devices, kw)
