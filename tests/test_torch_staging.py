"""``api.diag``'s moves through the staging slots (``staging.Stager``), on
the CPU device: the answers are bit-equal to the unstaged moves of
``use_kernels=False`` (the same plain path here) with and without sea ice,
with 1-D and 3-D pressure, over more steps than the ring has slots; the
counter ``staged_bytes`` counts every float32 byte moved in and read back,
and ``h2d_bytes`` what the unstaged moves count; the arrays a call returns
are its own; a big-endian input gives the native input's answers; the
slots' memory does not grow with the calls.

Imports neither JAX nor the JAX package."""
import numpy as np
import pytest
import torch

from bench import make_world
from seabreeze_param_tpu_torch import api, staging
from seabreeze_param_tpu_torch.utils import tracing

NLAT, NLON, NLEV = 40, 56, 5
#: more steps than slots, so that both rings wrap within a call
T = 2 * staging.SLOTS + 1
PLANE = NLAT * NLON * 4
CASES = [(ice, pres) for ice in ("ice", "noice") for pres in ("1d", "3d")]


@pytest.fixture
def world():
    lsm, z, std, pres, theta, u, v, ci = make_world(NLAT, NLON, NLEV, T,
                                                    seed=21)
    u = u + np.arange(NLEV, dtype=np.float32)[None, :, None, None]
    for t in range(T):
        ci[t, : 3 + t % 4] = 0.9                 # the coastline moves
    lat = np.linspace(58.0, 40.0, NLAT).astype(np.float32)
    lon = np.linspace(-8.0, 20.0, NLON, endpoint=False).astype(np.float32)
    col = 1.0 + 0.02 * np.sin(np.arange(NLAT * NLON, dtype=np.float32))
    pres3 = (pres[:, None, None] * col.reshape(NLAT, NLON)).astype(
        np.float32)
    return dict(lsm=lsm, z=z, std=std, pres=pres, pres3=pres3, theta=theta,
                u=u, v=v, ci=ci, lat=lat, lon=lon)


@pytest.fixture(autouse=True)
def fresh():
    tracing.tracer.reset()
    api.clear_exec_cache()
    yield tracing.tracer
    tracing.tracer.reset()
    api.clear_exec_cache()


def _args(w, ice, pres):
    return (w["lsm"], w["z"], w["std"], w["lon"], w["lat"],
            w["pres3"] if pres == "3d" else w["pres"], w["u"], w["v"],
            w["theta"], w["ci"] if ice == "ice" else None)


def _two_calls(args, **kw):
    """Two calls, the second from the first's state; both calls' returns."""
    first = api.diag(1, *args, device="cpu", **kw)
    tt, _, thc, ws, wd = first
    return first, api.diag(tt, *args, ws=ws, wd=wd, thc=thc, device="cpu",
                           **kw)


def _profiled(fn):
    """``fn()`` under a CPU profiler session, which turns the counters on."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def _counters(tracer, fn):
    tracer.reset()
    _profiled(fn)
    return dict(tracer.counters)


@pytest.mark.parametrize("ice,pres", CASES)
def test_staged_bit_equal_to_unstaged(world, ice, pres):
    args = _args(world, ice, pres)
    staged = _two_calls(args)
    unstaged = _two_calls(args, use_kernels=False)
    for got, want in zip(staged, unstaged):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert staged[1][0] == 1 + 2 * T


@pytest.mark.parametrize("ice,pres", CASES)
def test_staged_bytes_count_every_move(world, fresh, ice, pres):
    args = _args(world, ice, pres)
    api.diag(1, *args, device="cpu")              # builds the caches
    got = _counters(fresh, lambda: api.diag(1, *args, device="cpu"))
    ice_planes = ice == "ice"
    levels = NLEV if pres == "3d" else 1
    pres_bytes = NLEV * PLANE if pres == "3d" else 4
    # lsm, z, std, the state in; ci[0] again for the probe
    up = ((6 + ice_planes) * PLANE + pres_bytes
          + T * (1 + 2 * levels + ice_planes) * PLANE)
    back = (T + 3) * PLANE                        # sb_con, the state out
    assert got["staged_bytes"] == up + back
    assert got["h2d_bytes"] == up


@pytest.mark.parametrize("ice,pres", CASES)
def test_h2d_bytes_as_the_unstaged_moves(world, fresh, ice, pres):
    args = _args(world, ice, pres)
    staged = _counters(fresh, lambda: api.diag(1, *args, device="cpu"))
    unstaged = _counters(fresh, lambda: api.diag(1, *args, device="cpu",
                                                 use_kernels=False))
    assert staged["h2d_bytes"] == unstaged["h2d_bytes"] > 0
    assert "staged_bytes" not in unstaged


def test_mesh_is_not_staged(world, fresh):
    got = _counters(fresh, lambda: api.diag(
        1, *_args(world, "ice", "1d"), device="cpu", mesh="2x2"))
    assert got["h2d_bytes"] > 0 and "staged_bytes" not in got


@pytest.mark.parametrize("ice", ["ice", "noice"])
def test_returned_arrays_are_the_callers(world, ice):
    args = _args(world, ice, "1d")
    first, second = _two_calls(args)
    kept = [a.copy() for a in first[1:]]
    # a third call on other winds, from the same state as the second
    u2 = world["u"][::-1].copy()
    third = api.diag(first[0], *args[:6], u2, *args[7:], ws=first[3],
                     wd=first[4], thc=first[2], device="cpu")
    for a, b in zip(first[1:], kept):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(third[1], second[1])
    stager = next(iter(api._CACHE.values())).stager()
    slots = [s.buf.numpy() for s in stager._in + stager._out]
    arrays = [a for call in (first, second, third) for a in call[1:]]
    for i, a in enumerate(arrays):
        assert a.flags.writeable and a.flags.c_contiguous
        assert not any(np.shares_memory(a, s) for s in slots)
        assert not any(np.shares_memory(a, b) for b in arrays[i + 1:])


@pytest.mark.parametrize("pres", ["1d", "3d"])
def test_big_endian_as_native(world, pres):
    args = _args(world, "ice", pres)
    be = tuple(a.astype(">f4") for a in args)
    assert be[6].dtype == np.dtype(">f4")
    native = _two_calls(args)
    swapped = api.diag(1, *be, device="cpu")
    swapped = (swapped, api.diag(swapped[0], *be, ws=swapped[3].astype(">f4"),
                                 wd=swapped[4].astype(">f4"),
                                 thc=swapped[2].astype(">f4"), device="cpu"))
    for got, want in zip(swapped, native):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_strided_and_read_only_inputs(world):
    """Inputs torch cannot take as they are (a negative stride, a read-only
    array) give the answers of their contiguous copies."""
    args = _args(world, "ice", "1d")
    flipped = tuple(np.flip(a, -1) if i in (0, 6, 7, 8, 9) else a
                    for i, a in enumerate(args))
    want = api.diag(1, *(a.copy() for a in flipped), device="cpu")
    for a in flipped:
        a.flags.writeable = False
    got = api.diag(1, *flipped, device="cpu")
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_slot_memory_bounded_over_calls(world):
    args = _args(world, "ice", "1d")
    api.diag(1, *args, device="cpu")
    pipe = next(iter(api._CACHE.values()))
    held = pipe.stager().host_bytes
    # one step of theta, u and v at the level read, and ci, an input
    # slot; one plane an output slot
    assert held == staging.SLOTS * (4 + 1) * PLANE
    results = [api.diag(1, *args, device="cpu") for _ in range(6)]
    assert pipe.stager().host_bytes == held
    assert len(results) == 6 and len(api._CACHE) == 1
