"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Imports nothing of JAX, so it also runs where JAX is absent; there the
repo's conftest (which imports JAX) is skipped:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips: the kernels have no CPU mode.
Grids include a ragged tile edge (37 x 70) and a grid smaller than one
tile (10 x 20), whose wrap seam pushes the ring radius up.  Kernels B1 and
B2 carry ``TriggerPipeline.run``; B3 the fused distance, B4 the per-step
coupling path, B5 the ring search alone, B6 the halo exchange of the
decomposed run (``ShardedPipeline``), on ragged and 1-wide meshes.
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
    min_haversine_param_cuda, pass2_min_cuda)
from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import halo_exchange_cuda
from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
    StackedScan, ring_thc_cuda_padded, ring_trigger_cuda_padded,
    ring_trigger_cuda_stacked)
from seabreeze_param_tpu_torch.ops.distance import (
    device_tables, min_haversine_param_from_padded, pad_coast, pass1_extrema,
    pass2_min)
from seabreeze_param_tpu_torch.ops.ring_search import (ring_quantities,
                                                       ring_thc_from_padded)
from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                   trigger_cells)
from seabreeze_param_tpu_torch.parallel.halo import halo_exchange_plain
from seabreeze_param_tpu_torch.parallel.mesh import ShardMesh, make_mesh, split
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

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
    Mmin = pass1_extrema(pad_coast(coast, k), sdlam2, k)
    before = pass2_min_cuda.launches
    got = pass2_min_cuda(Mmin, sdphi2, po, k)
    assert pass2_min_cuda.launches == before + 1
    torch.testing.assert_close(got, pass2_min(Mmin, sdphi2, po, k), rtol=0,
                               atol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_diag_kernel_path_matches_plain_path(name, dev):
    """Three steps from tt=14 across the tt=15 refresh, ice appearing at
    step 1: per-step fields within 2e-5/2e-4, final wind state bit-equal,
    each kernel launched once per step (B2 also once for the probe)."""
    grid, (lsm, z, std, pres, theta, u, v, ci) = _world(name)
    rng = np.random.default_rng(0)
    ws = (5 + rng.random(lsm.shape)).astype(np.float32)
    wd = (360 * rng.random(lsm.shape) - 180).astype(np.float32)
    args = (14, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta, ci)
    kw = dict(ws=ws, wd=wd, thc=np.zeros_like(ws), full_output=True)
    p0, r0 = pass2_min_cuda.launches, ring_trigger_cuda_stacked.launches
    kern = diag(*args, device=dev, **kw)
    assert ring_trigger_cuda_stacked.launches - r0 == 3
    assert pass2_min_cuda.launches - p0 == 4
    plain = diag(*args, device=dev, use_kernels=False, **kw)
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        _close(torch.as_tensor(kern[5][key]), torch.as_tensor(plain[5][key]),
               key)
    np.testing.assert_array_equal(kern[3], plain[3])
    np.testing.assert_array_equal(kern[4], plain[4])


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
    """A radius too wide for one block's shared memory: the launcher's
    cudaFuncSetAttribute fails, the wrapper raises and counts no launch,
    and the next good launch is not blamed for the error."""
    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    k = 1000                                  # B2: ~1.5 MB per block
    p0, r0 = pass2_min_cuda.launches, ring_trigger_cuda_stacked.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        pass2_min_cuda(zeros(10 + 2 * k, 16), zeros(10, 2 * k + 1),
                       zeros(10, 2 * k + 1), k)
    h, w, nn = 8, 8, 60                       # B1: 246784 bytes per block
    params = Params()
    scan = StackedScan(h, w, params, dev)
    bufs = scan.init_buffers(1, zeros(h, w), zeros(h, w))
    with pytest.raises(RuntimeError, match="cudaError_t"):
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
    """B3 at a radius of 1000 cells and B4/B5 at NN = 60 need more shared
    memory than a block may hold: each wrapper raises, counts no launch,
    and the next good launch is not blamed."""
    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    counts = lambda: (min_haversine_param_cuda.launches,  # noqa: E731
                      ring_trigger_cuda_padded.launches,
                      ring_thc_cuda_padded.launches)
    before = counts()
    h, w, k = 10, 16, 1000                    # B3: ~17 MB per block
    with pytest.raises(RuntimeError, match="cudaError_t"):
        min_haversine_param_cuda(zeros(h + 2 * k, w + 2 * k),
                                 zeros(h, 2 * k + 1), zeros(h, 2 * k + 1),
                                 zeros(w, 2 * k + 1), k)
    h, w, nn = 8, 8, 60                       # B4, B5: 246784 bytes
    pads = (zeros(h + 2 * nn, w + 2 * nn), zeros(h + 2 * nn, w + 2 * nn))
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ring_trigger_cuda_padded(*pads, *(zeros(h, w) for _ in range(5)),
                                 False, False, Params(), nn)
    with pytest.raises(RuntimeError, match="cudaError_t"):
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
    k = 0 (a one-tap window); and against the hybrid (torch pass 1 + B2)."""
    grid, (lsm, *_, ci) = _world(name)
    k = TriggerPipeline(grid, device=dev).k if radius == "k" else 0
    tabs = device_tables(grid, k, dev)
    coast = get_edges(torch.as_tensor(lsm, device=dev),
                      torch.as_tensor(ci[1], device=dev))
    cpad = pad_coast(coast, k)
    before = min_haversine_param_cuda.launches
    got = min_haversine_param_cuda(cpad, *tabs, k)
    assert min_haversine_param_cuda.launches == before + 1
    torch.testing.assert_close(
        got, min_haversine_param_from_padded(cpad, *tabs, k), rtol=0, atol=0)
    torch.testing.assert_close(
        got, pass2_min_cuda(pass1_extrema(cpad, tabs[2], k), tabs[0],
                            tabs[1], k), rtol=0, atol=0)


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
    bit-equal, B4 once per step.  The fused distance (B3) gives the
    default distance field bit for bit, and a fused ``run`` the default
    run's outputs."""
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

    fused = TriggerPipeline(grid, device=dev, distance_impl="fused")
    default = TriggerPipeline(grid, device=dev)
    lsm_d, ci_d = torch.as_tensor(lsm, device=dev), torch.as_tensor(
        ci, device=dev)
    torch.testing.assert_close(fused.distance_field(lsm_d, ci_d[1]),
                               default.distance_field(lsm_d, ci_d[1]),
                               rtol=0, atol=0)
    b3 = min_haversine_param_cuda.launches
    fin = [p.run(TriggerState.zeros(lsm.shape, dev), theta, u, v, lsm, z,
                 std, pres, ci_t=ci) for p in (fused, default)]
    assert min_haversine_param_cuda.launches - b3 == len(ci)
    for key in fin[1][1]:
        torch.testing.assert_close(fin[0][1][key], fin[1][1][key], rtol=0,
                                   atol=0)


#: name -> (mesh shape, field shape): ragged shards (37 x 35 is no multiple
#: of the kernel's 32 x 8 block), 1-wide mesh axes, one shard.
HALO_MESHES = {
    "2x4": ((2, 4), (74, 140)),
    "3x3": ((3, 3), (33, 99)),
    "1x7": ((1, 7), (30, 84)),
    "5x1": ((5, 1), (55, 40)),
    "1x1": ((1, 1), (37, 70)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(HALO_MESHES))
@pytest.mark.parametrize("lat_fill,exact_lon", [("clamp", True),
                                                ("clamp", False),
                                                ("zero", False)])
@pytest.mark.parametrize("channels", [1, 2])
def test_halo_kernel_bit_equal_to_plain(name, lat_fill, exact_lon, channels,
                                        dev):
    """B6 against its plain version, bit for bit, one launch per exchange,
    at 1-wide, uneven, one-sided and full-shard widths."""
    (py, px), (nlat, nlon) = HALO_MESHES[name]
    mesh = make_mesh((py, px), dev)
    shape = (channels, nlat, nlon) if channels > 1 else (nlat, nlon)
    field = np.random.default_rng(7).standard_normal(shape)
    local = split(torch.as_tensor(field.astype(np.float32), device=dev),
                  mesh)
    h, w = nlat // py, nlon // px
    for hy, hx in ((1, 1), (3, 2), (0, 2), (2, 0),
                   (h, w - 1 if exact_lon else w)):
        kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
        before = halo_exchange_cuda.launches
        got = halo_exchange_cuda(local, mesh, hy, hx, **kw)
        assert halo_exchange_cuda.launches == before + 1
        want = halo_exchange_plain(local, mesh, hy, hx, **kw)
        for g, r in zip(got, want):
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
