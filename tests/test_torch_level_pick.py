"""``api.diag`` with 1-D pressure reads and moves u and v at the one level
the trigger reads, picked on the host by ``ops.trigger.nearest_level``:
its answers are bit-equal to ``TriggerPipeline.run`` (or the decomposed
run) fed every level, whatever the target (first, last, between two
levels, a tie), input form (single step, big-endian, masked sea ice, a
lazy handle) or mesh; 3-D pressure still moves every level; the counter
``h2d_bytes`` counts the one level and the 2-D fields.

Imports neither JAX nor the JAX package."""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu_torch import api
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.coupling import CoupledTrigger
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.trigger import nearest_level
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline
from seabreeze_param_tpu_torch.utils import tracing

NLAT, NLON, NLEV, T = 40, 56, 5, 2
PRES = np.array([100000.0, 90000.0, 80000.0, 70000.0, 60000.0], np.float32)
PLANE = NLAT * NLON * 4
#: target_plev (hPa) -> the level nearest it
TARGETS = {"first": (1000.0, 0), "last": (600.0, 4), "between": (720.0, 3),
           "tie": (850.0, 1), "below_all": (100.0, 4)}


@pytest.fixture
def world():
    lsm, z, std, _, theta, u, v, ci = make_world(NLAT, NLON, NLEV, T, seed=9)
    # every level distinct, so a wrong level shows in the winds
    u = u + np.arange(NLEV, dtype=np.float32)[None, :, None, None]
    v = v - 2 * np.arange(NLEV, dtype=np.float32)[None, :, None, None]
    ci[1, :5] = 0.9
    lat = np.linspace(58.0, 40.0, NLAT).astype(np.float32)
    lon = np.linspace(-8.0, 20.0, NLON, endpoint=False).astype(np.float32)
    return dict(lsm=lsm, z=z, std=std, pres=PRES.copy(), theta=theta, u=u,
                v=v, ci=ci, lat=lat, lon=lon)


@pytest.fixture(autouse=True)
def fresh():
    tracing.tracer.reset()
    api.clear_exec_cache()
    yield tracing.tracer
    tracing.tracer.reset()
    api.clear_exec_cache()


class LazyVar:
    """A netCDF-like variable handle that logs the keys it is read with."""

    def __init__(self, a):
        self.a, self.keys = a, []
        self.shape, self.dtype = a.shape, a.dtype

    def __getitem__(self, key):
        self.keys.append(key)
        return self.a[key]


def _spy(monkeypatch, cls):
    """Record the arguments of ``cls.run``; return them and the unpatched
    ``run``."""
    seen, real = {}, cls.run

    def run(self, state, theta_t, u_t, v_t, lsm, z, std, pres, ci_t=None,
            nn=None, **feed):
        seen.update(pipe=self, state=state, theta=theta_t, u=u_t, v=v_t,
                    lsm=lsm, z=z, std=std, pres=pres, ci=ci_t, nn=nn)
        return real(self, state, theta_t, u_t, v_t, lsm, z, std, pres,
                    ci_t=ci_t, nn=nn, **feed)
    monkeypatch.setattr(cls, "run", run)
    return seen, real


def _call(w, pres=None, u=None, v=None, theta=None, ci="world", **kw):
    return api.diag(1, w["lsm"], w["z"], w["std"], w["lon"], w["lat"],
                    w["pres"] if pres is None else pres,
                    w["u"] if u is None else u, w["v"] if v is None else v,
                    w["theta"] if theta is None else theta,
                    w["ci"] if isinstance(ci, str) else ci, device="cpu",
                    full_output=True, **kw)


def _profiled(fn):
    """``fn()`` under a CPU profiler session, which turns the counters on."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def _assert_same(got, seen, real, u_all, v_all, pres_all):
    """``got`` (diag's six returns) bit-equal to the spied pipeline's run
    fed every level of u, v and pres."""
    final, outs = real(seen["pipe"], seen["state"], seen["theta"], u_all,
                       v_all, seen["lsm"], seen["z"], seen["std"], pres_all,
                       ci_t=seen["ci"], nn=seen["nn"])
    assert got[0] == 1 + u_all.shape[0]
    np.testing.assert_array_equal(got[1], outs["sb_con"].numpy())
    for have, want in zip(got[2:5], (final.thc, final.windspeed,
                                     final.winddir)):
        np.testing.assert_array_equal(have, want.numpy())
    assert sorted(got[5]) == sorted(outs)
    for key, o in outs.items():
        np.testing.assert_array_equal(got[5][key], o.numpy())


@pytest.mark.parametrize("where", sorted(TARGETS))
def test_one_level_bit_equal_to_every_level(world, monkeypatch, where):
    target, lev = TARGETS[where]
    seen, real = _spy(monkeypatch, TriggerPipeline)
    got = _call(world, target_plev=target)
    assert seen["u"].shape == (T, 1, NLAT, NLON)
    np.testing.assert_array_equal(seen["u"], world["u"][:, lev:lev + 1])
    np.testing.assert_array_equal(seen["v"], world["v"][:, lev:lev + 1])
    np.testing.assert_array_equal(seen["pres"], PRES[lev:lev + 1])
    _assert_same(got, seen, real, world["u"], world["v"], PRES)
    # the levels differ: the winds at another level are other winds
    other = _call(world, pres=PRES[::-1].copy(), target_plev=target)
    assert not np.array_equal(other[5]["windspeed"], got[5]["windspeed"])


def test_nearest_level_is_the_first_argmin():
    for target, lev in TARGETS.values():
        pa = np.float32(target) * np.float32(100.0)
        assert int(nearest_level(torch.tensor(PRES), pa)) == lev
        assert int(nearest_level(torch.tensor(PRES[lev:lev + 1]), pa)) == 0


def test_single_step(world, monkeypatch):
    seen, real = _spy(monkeypatch, TriggerPipeline)
    got = _call(world, u=world["u"][0], v=world["v"][0],
                theta=world["theta"][0], ci=world["ci"][0])
    assert seen["u"].shape == (1, 1, NLAT, NLON)
    _assert_same(got, seen, real, world["u"][:1], world["v"][:1], PRES)


def test_big_endian_and_masked_ice(world, monkeypatch):
    be = {k: world[k].astype(">f4") for k in ("u", "v", "theta", "pres")}
    mask = np.zeros(world["ci"].shape, bool)
    mask[:, NLAT // 2:, :7] = True
    ci = np.ma.masked_array(np.where(mask, 0.7, world["ci"]), mask=mask)
    seen, real = _spy(monkeypatch, TriggerPipeline)
    got = _call(world, pres=be["pres"], u=be["u"], v=be["v"],
                theta=be["theta"], ci=ci)
    assert np.asarray(seen["u"]).dtype == np.float32
    np.testing.assert_array_equal(seen["ci"], ci.filled(0))
    _assert_same(got, seen, real, world["u"], world["v"], PRES)


def test_lazy_handle_read_at_one_level(world, monkeypatch):
    u, v = LazyVar(world["u"]), LazyVar(world["v"])
    seen, real = _spy(monkeypatch, TriggerPipeline)
    got = _call(world, u=u, v=v)                     # 700 hPa: level 3
    assert u.keys == v.keys == [(slice(None), slice(3, 4))]
    _assert_same(got, seen, real, world["u"], world["v"], PRES)


def test_mesh_bit_equal_to_every_level(world, monkeypatch):
    seen, real = _spy(monkeypatch, ShardedPipeline)
    got = _call(world, mesh="2x2")
    assert seen["u"].shape == (T, 1, NLAT, NLON)
    _assert_same(got, seen, real, world["u"], world["v"], PRES)


def test_3d_pressure_moves_every_level(world, monkeypatch, fresh):
    col = 1.0 + 0.02 * np.sin(np.arange(NLAT * NLON, dtype=np.float32))
    pres3 = (PRES[:, None, None] * col.reshape(NLAT, NLON)).astype(
        np.float32)
    seen, real = _spy(monkeypatch, TriggerPipeline)
    got = _profiled(lambda: _call(world, pres=pres3))
    assert seen["u"].shape == (T, NLEV, NLAT, NLON)
    assert seen["pres"].shape == (NLEV, NLAT, NLON)
    _assert_same(got, seen, real, world["u"], world["v"], pres3)


def test_skipped_bytes_counter(world, fresh):
    _call(world)
    assert not fresh.counters                    # no profiler: no count
    _profiled(lambda: _call(world))
    skipped = 2 * T * (NLEV - 1) * PLANE + (NLEV - 1) * 4
    every_level = (world["u"].nbytes + world["v"].nbytes
                   + world["theta"].nbytes + world["ci"].nbytes
                   + 7 * PLANE + PRES.nbytes)
    assert fresh.counters["h2d_bytes"] == every_level - skipped

    fresh.reset()
    ct = CoupledTrigger(grid=Grid(lon=world["lon"], lat=world["lat"]),
                        device="cpu")

    def step():
        mask = ct.prepare_mask(world["lsm"], world["ci"][0])
        ct.physics(TriggerState.zeros((NLAT, NLON), "cpu"), world["pres"],
                   world["u"][0], world["v"][0], world["theta"][0],
                   world["z"], world["std"], mask)
    _profiled(step)
    assert fresh.counters["h2d_bytes"] > 0
