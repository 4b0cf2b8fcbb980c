"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Imports nothing of JAX, so it also runs where JAX is absent; there the
repo's conftest (which imports JAX) is skipped:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips: the kernels have no CPU mode.
Grids include a ragged tile edge (37 x 70) and a grid smaller than one
tile (10 x 20), whose wrap seam pushes the ring radius up.
"""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.coastline import get_edges
from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import pass2_min_cuda
from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
    StackedScan, ring_trigger_cuda_stacked)
from seabreeze_param_tpu_torch.ops.distance import (device_tables,
                                                    pad_coast, pass1_extrema,
                                                    pass2_min)
from seabreeze_param_tpu_torch.ops.trigger import (cadence, prepare_step,
                                                   trigger_cells)

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
