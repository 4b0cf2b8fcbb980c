"""The ring-radius probe on the device (``ops.ring_search.
required_ring_radius``): the integer of the JAX package's exact host
function ``required_ring_radius_host`` (two scipy chamfer transforms) on
random coasts at several land shares, on degenerate masks, at caps around
the answer and past the domain, on frames wider than the short axis and
across the quirky longitude seam; ``ops.ring_search.ring_bound`` on the
worlds of ``tests/test_torch_large_nn.py`` and on the 64 x 512 cut of the
London cell (k = 462); and ``api.diag``'s probe, which reads back one
integer a pass and no field, and runs each call at its own bound."""
import numpy as np
import pytest
import torch

import seabreeze_param_tpu.ops.ring_search as jring
from seabreeze_param_tpu.ops.ring_search import required_ring_radius_host
from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops import ring_search
from seabreeze_param_tpu_torch.ops.ring_search import (
    required_ring_radius, ring_bound, static_ring_bound)
from seabreeze_param_tpu_torch.utils import tracing

MAXDIST = 180.0


@pytest.fixture(autouse=True)
def quiet_tracer():
    """The process-global tracer off and empty, and no cached pipelines,
    before and after."""
    tracing.tracer.reset()
    api.clear_exec_cache()
    yield tracing.tracer
    tracing.tracer.enabled = False
    tracing.tracer.reset()
    api.clear_exec_cache()


def _coast(shape, land_share, seed):
    """A random land mask as a distance field: |cdist| uniform in [0, 2
    maxdist), so about half the cells are targets; land >= 0."""
    rng = np.random.default_rng(seed)
    land = rng.random(shape) < land_share
    mag = (2 * MAXDIST * rng.random(shape)).astype(np.float32)
    return np.where(land, mag, -mag - 0.5).astype(np.float32)


def _device(cdist, **kw):
    got = required_ring_radius(torch.as_tensor(cdist), MAXDIST, **kw)
    assert got.shape == () and got.dtype == torch.int64
    return int(got)


@pytest.mark.parametrize("exact_lon", [True, False])
@pytest.mark.parametrize("shape", [(9, 13), (4, 40), (31, 7)])
@pytest.mark.parametrize("land_share", [0.02, 0.2, 0.5, 0.8, 0.98])
def test_matches_host_on_random_coasts(land_share, shape, exact_lon):
    """Caps below the answer, at it, one above it, at the domain and past
    it; (4, 40) pads its rows by more than there are."""
    cdist = _coast(shape, land_share, seed=int(100 * land_share) + shape[0])
    answer = required_ring_radius_host(cdist, MAXDIST, exact_lon=exact_lon)
    domain = max(shape)
    caps = {None, max(1, answer - 1), answer, answer + 1, domain,
            domain + 5}
    for cap in sorted(caps, key=lambda c: -1 if c is None else c):
        assert _device(cdist, exact_lon=exact_lon, cap=cap) == \
            required_ring_radius_host(cdist, MAXDIST, exact_lon=exact_lon,
                                      cap=cap), cap


def _one_land(shape, at):
    cdist = np.full(shape, -10.0, np.float32)
    cdist[at] = 10.0
    return cdist


DEGENERATE = {
    "all_land": np.full((6, 9), 10.0, np.float32),
    "all_sea": np.full((6, 9), -10.0, np.float32),
    "no_target": np.where(_coast((6, 9), 0.5, 1) >= 0, 500.0,
                          -500.0).astype(np.float32),
    "one_land_cell": _one_land((7, 9), (3, 4)),
    "one_land_corner": _one_land((7, 9), (0, 8)),
}


@pytest.mark.parametrize("exact_lon", [True, False])
@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_matches_host_on_degenerate_masks(name, exact_lon):
    cdist = DEGENERATE[name]
    for cap in (None, 1, 3, 20):
        assert _device(cdist, exact_lon=exact_lon, cap=cap) == \
            required_ring_radius_host(cdist, MAXDIST, exact_lon=exact_lon,
                                      cap=cap), cap


def test_matches_host_across_the_longitude_seam():
    """Land in the last two columns, the targets in column 0: the nearest
    land lies across the seam, at 2 columns through the quirky map (its
    left pad reads column 0, then nlon - 2) and at 1 through the periodic
    one."""
    cdist = np.full((6, 20), -(MAXDIST + 100.0), np.float32)
    cdist[:, -2:] = MAXDIST + 100.0
    cdist[:, 0] = -10.0
    for exact_lon, want in ((True, 2), (False, 1)):
        assert required_ring_radius_host(cdist, MAXDIST,
                                         exact_lon=exact_lon) == want
        assert _device(cdist, exact_lon=exact_lon) == want


def test_rejects_a_cap_below_one():
    with pytest.raises(ValueError, match="cap"):
        required_ring_radius(torch.zeros(3, 3), MAXDIST, cap=0)


def _far_sea(nlat=10, nlon=100):
    """Land everywhere but one sea column: the probe doubles its frame
    from 8 to 64."""
    cdist = np.ones((nlat, nlon), np.float32)
    cdist[:, 0] = -1.0
    return cdist


def _events(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events())


def _inside(events, outer, name):
    """How many ``name`` spans lie inside each ``outer`` span."""
    return [sum(1 for s, e, n in events if n == name and s0 <= s and e <= e0)
            for s0, e0, n0 in events if n0 == outer]


def _bound(cdist, k, params):
    """What :func:`ring_bound` must give: the static bound, or the host
    function's radius plus the margin, whichever is larger."""
    return max(static_ring_bound(k, params),
               required_ring_radius_host(
                   np.asarray(cdist), params.maxdist,
                   exact_lon=params.exact_lon_indexing)
               + params.ring_search_margin)


def _probed(monkeypatch, cdist, k, params):
    """:func:`ring_bound` with the static bound out of the way: the radius
    its probe loop finds, plus the margin."""
    with monkeypatch.context() as m:
        m.setattr(ring_search, "static_ring_bound", lambda k, params: 0)
        return ring_bound(cdist, k, params)


def test_ring_radius_reads_back_one_integer_a_pass():
    cdist = _far_sea()
    params = Params()
    out = []
    events = _events(lambda: out.append(ring_bound(cdist, 1, params)))
    assert out[0] == _bound(cdist, 1, params)
    assert out[0] > static_ring_bound(1, params)    # the probe decides
    assert _inside(events, "probe:transform", "wait:probe_readback") == [
        1, 1, 1, 1]
    assert [n for _, _, n in events].count("wait:probe_readback") == 4
    # a tensor and a host array give the same
    assert ring_bound(torch.as_tensor(cdist), 1, params) == out[0]


def _small_world():
    """12 x 40 cells at 0.25 deg from the equator (k = 4): land east of a
    wavy line, one pressure level, two steps.  The probe's radius passes
    the static bound, and its first frame (cap 16) pads the rows by more
    than there are and is too narrow, so it takes a second pass."""
    lat = np.linspace(0.0, -11 * 0.25, 12).astype(np.float32)
    lon = np.linspace(0.0, 40 * 0.25, 40, endpoint=False).astype(np.float32)
    y, x = np.mgrid[:12, :40]
    lsm = (x > 20 + 2 * np.sin(y / 2.0)).astype(np.float32)
    return lon, lat, lsm


def _spy_nn(monkeypatch):
    """The ``nn`` of every ``TriggerPipeline.run`` call, in order."""
    seen, real = [], TriggerPipeline.run

    def run(self, *args, nn=None, **kwargs):
        seen.append(nn)
        return real(self, *args, nn=nn, **kwargs)
    monkeypatch.setattr(TriggerPipeline, "run", run)
    return seen


def test_diag_probe_reads_back_no_field(monkeypatch):
    """``api.diag`` calls neither the host function nor scipy's transform,
    picks the NN the host function gives, reads back one integer a pass,
    and uploads no pad index in its probe."""
    lon, lat, lsm = _small_world()
    params = Params()
    pipe = TriggerPipeline(grid=Grid(lon=lon, lat=lat), params=params,
                           device="cpu")
    cdist0 = pipe.distance_field(torch.as_tensor(lsm), None).numpy()
    want = _bound(cdist0, pipe.k, params)
    assert want > pipe.nn_max               # the probe decides the NN

    def refuse(*args, **kwargs):
        raise AssertionError("the host transform ran")
    monkeypatch.setattr(jring, "required_ring_radius_host", refuse)
    scipy_ndimage = pytest.importorskip("scipy.ndimage")
    monkeypatch.setattr(scipy_ndimage, "distance_transform_cdt", refuse)

    seen = _spy_nn(monkeypatch)
    zeros = np.zeros((2, 1) + lsm.shape, np.float32)
    events = _events(lambda: api.diag(
        1, lsm, lsm, lsm, lon, lat, np.array([70000.0], np.float32), zeros,
        zeros, zeros[:, 0] + 288.0, None, device="cpu"))
    assert seen == [want]
    assert _inside(events, "probe:transform", "wait:probe_readback") == [
        1, 1]
    assert _inside(events, "api:probe", "wait:probe_readback") == [2]
    assert _inside(events, "api:probe", "wait:pad_take_index") == [0]


def test_diag_runs_each_call_at_its_own_bound(monkeypatch):
    """Two fields on one grid whose bounds both pass the static bound: the
    far sea needs 18, the same coast with a sea column inside the land 11.
    The two calls build one pipeline; the second runs at its own bound,
    not the first's; each call gives what it gives on a fresh cache."""
    lon, lat, lsm = _small_world()
    inland = lsm.copy()
    inland[:, 30] = 0.0
    zeros = np.zeros((2, 1) + lsm.shape, np.float32)

    def call(land):
        return api.diag(1, land, land, land, lon, lat,
                        np.array([70000.0], np.float32), zeros, zeros,
                        zeros[:, 0] + 288.0, None, device="cpu",
                        full_output=True)

    seen = _spy_nn(monkeypatch)
    misses = api.CACHE_STATS["pipeline_misses"]
    got = [call(lsm), call(inland)]
    assert api.CACHE_STATS["pipeline_misses"] == misses + 1
    assert len(api._CACHE) == 1
    assert seen == [18, 11]
    assert static_ring_bound(4, Params()) < 11
    for land, out in zip((lsm, inland), got):
        api.clear_exec_cache()
        fresh = call(land)
        assert out[0] == fresh[0]
        for a, b in zip(out[1:5], fresh[1:5]):
            np.testing.assert_array_equal(a, b)
        for key in fresh[5]:
            np.testing.assert_array_equal(out[5][key], fresh[5][key])


def _port_cdist(lsm, ci0, lon, lat):
    pipe = TriggerPipeline(grid=Grid(lon=lon, lat=lat), device="cpu",
                           use_kernels=False)
    return pipe, pipe.distance_field(
        torch.as_tensor(lsm), None if ci0 is None else torch.as_tensor(ci0))


@pytest.mark.parametrize("name", ["80x96", "48x256"])
def test_ring_radius_matches_host_on_large_nn_worlds(name, monkeypatch):
    from tests.test_torch_large_nn import world
    lsm, *_, ci, lat, lon = world(name)
    pipe, cdist = _port_cdist(lsm, ci[0], lon, lat)
    assert ring_bound(cdist, pipe.k, pipe.params) == _bound(
        cdist, pipe.k, pipe.params)
    assert _probed(monkeypatch, cdist, pipe.k, pipe.params) == (
        required_ring_radius_host(cdist.numpy(), MAXDIST)
        + pipe.params.ring_search_margin)


def test_ring_radius_matches_host_on_the_london_cut(monkeypatch):
    from portbench import world
    from tests.test_torch_subkm_config import CUT_H, CUT_W, _grid
    lon, lat = _grid(CUT_H, CUT_W)
    cpu = torch.device("cpu")
    lsm, _, _ = world.make_world(CUT_H, CUT_W,
                                 world.generator(2**31 + 2**20 + 3, cpu), cpu)
    pipe, cdist = _port_cdist(lsm.numpy(), None, lon, lat)
    assert pipe.k == 462
    assert ring_bound(cdist, pipe.k, pipe.params) == _bound(
        cdist, pipe.k, pipe.params)
    assert _probed(monkeypatch, cdist, pipe.k, pipe.params) == (
        required_ring_radius_host(cdist.numpy(), MAXDIST)
        + pipe.params.ring_search_margin)
