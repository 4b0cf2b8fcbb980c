"""The port's decomposed run (``parallel/sharded.py``) against the JAX
package's ``ShardedPipeline`` on the same mesh of virtual CPU devices, and
against the port's single-device ``TriggerPipeline``; mirrors
``tests/test_sharded.py`` test by test, with its tolerances, on the same
fixtures (2 steps).  The JAX side runs its XLA path (its own tests hold the
Pallas path to it).  Then ``diag(mesh=...)``, the dummy model's
``--sharded`` and the mesh-wide sigmoid."""
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from seabreeze_param_tpu.api import diag as jdiag
from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.core.params import Params as JParams
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline as JPipe
from seabreeze_param_tpu.ops.orography import sigmoid_weight as jsigmoid
from seabreeze_param_tpu.parallel.mesh import make_mesh as jmake_mesh
from seabreeze_param_tpu.parallel.sharded import ShardedPipeline as JSharded
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.params import Params
from seabreeze_param_tpu_torch.core.state import TriggerState, state_from_numpy
from seabreeze_param_tpu_torch.examples import dummy_model as tdummy
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.orography import (sigmoid_weight,
                                                     sigmoid_weight_shards)
from seabreeze_param_tpu_torch.parallel.mesh import make_mesh, split
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

MISSING = np.float32(2.0e20)
NSTEPS = 2


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state_close(a, b):
    """``tests/test_sharded.py::_assert_state_close``."""
    assert int(a.tt) == int(b.tt)
    np.testing.assert_allclose(_np(a.thc), _np(b.thc), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(a.windspeed), _np(b.windspeed),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(a.winddir), _np(b.winddir), rtol=1e-5,
                               atol=1e-3)


def _assert_outputs_close(got, ref):
    """``tests/test_sharded.py::_assert_outputs_close``: MISSING structure
    equal, then rtol 1e-5 / atol 1e-4 with under 1e-3 of cells off."""
    for key in ref:
        g, r = _np(got[key]), _np(ref[key])
        assert g.shape == r.shape, key
        miss = r == MISSING
        np.testing.assert_array_equal(g == MISSING, miss, err_msg=key)
        mism = ~np.isclose(g[~miss], r[~miss], rtol=1e-5, atol=1e-4)
        assert mism.mean() < 1e-3, f"{key}: {mism.sum()}/{mism.size}"


def _assert_bit_equal(a_state, a_out, b_state, b_out):
    for key in a_out:
        torch.testing.assert_close(a_out[key], b_out[key], rtol=0, atol=0,
                                   msg=key)
    for f in ("thc", "windspeed", "winddir"):
        torch.testing.assert_close(getattr(a_state, f), getattr(b_state, f),
                                   rtol=0, atol=0, msg=f)
    assert a_state.tt == b_state.tt


def _inputs(c, pres=None, ci=True):
    return (c["theta_t"][:NSTEPS], c["u_t"][:NSTEPS], c["v_t"][:NSTEPS],
            c["lsm"], c["z"], c["std"], c["p"] if pres is None else pres,
            c["ci_t"][:NSTEPS] if ci else None)


def _jax_run(c, mesh_shape, *, params=None, state=None, overlap="auto",
             **kw):
    grid = JGrid(lon=c["lon"], lat=c["lat"])
    pipe = JPipe(grid, params=params or JParams())
    sp = JSharded(pipe, jmake_mesh(mesh_shape), overlap=overlap)
    if state is None:
        state = JState.zeros(c["lsm"].shape)
    *xs, ci = _inputs(c, **kw)
    return sp, sp.run(state, *xs, ci_t=ci)


def _port(c, mesh_shape=None, *, params=None, use_kernels=None, **sp_kw):
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]),
                           params=params or Params(), device="cpu",
                           use_kernels=use_kernels)
    if mesh_shape is None:
        return pipe
    return ShardedPipeline(pipe, make_mesh(mesh_shape, "cpu"), **sp_kw)


def _port_run(runner, c, state=None, **kw):
    if state is None:
        state = TriggerState.zeros(c["lsm"].shape, "cpu")
    *xs, ci = _inputs(c, **kw)
    return runner.run(state, *xs, ci_t=ci)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_jax_and_single_device(small_case, mesh_shape):
    c = small_case
    jsp, (j_state, j_out) = _jax_run(c, mesh_shape)
    sp = _port(c, mesh_shape)
    assert sp.overlap == jsp.overlap
    got_state, got_out = _port_run(sp, c)
    _assert_outputs_close(got_out, j_out)
    _assert_state_close(got_state, j_state)
    ref_state, ref_out = _port_run(_port(c), c)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_lat_padding(global_case):
    """nlat = 121 on 2 x 4: the replication padding to 122 rows, its
    valid-mask statistics, and the outputs sliced back to 121 rows."""
    c = global_case
    _, (j_state, j_out) = _jax_run(c, (2, 4))
    sp = _port(c, (2, 4))
    assert (sp.nlat_real, sp.nlat_pad) == (121, 122)
    got_state, got_out = _port_run(sp, c)
    assert got_out["sb_con"].shape == (NSTEPS, 121, 240)
    _assert_outputs_close(got_out, j_out)
    _assert_state_close(got_state, j_state)
    ref_state, ref_out = _port_run(_port(c), c)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_overlap_matches_basic(small_case):
    """Overlapped and basic structures bit-equal on one mesh; basic
    against the JAX basic structure."""
    c = small_case
    runs = []
    for overlap in (True, False):
        sp = _port(c, (2, 4), overlap=overlap)
        assert sp.overlap is overlap
        runs.append(_port_run(sp, c))
    _assert_bit_equal(*runs[0], *runs[1])
    _, (j_state, j_out) = _jax_run(c, (2, 4), overlap=False)
    _assert_outputs_close(runs[1][1], j_out)
    _assert_state_close(runs[1][0], j_state)


def test_halo_width_guard(small_case):
    """A mesh whose shard is narrower than the widest halo is refused up
    front, by both packages."""
    c = small_case
    jpipe = JPipe(JGrid(lon=c["lon"], lat=c["lat"]), ring_nn=50)
    with pytest.raises(ValueError, match="halo width"):
        JSharded(jpipe, jmake_mesh((8, 1)))
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]), ring_nn=50,
                           device="cpu")
    with pytest.raises(ValueError, match="halo width"):
        ShardedPipeline(pipe, make_mesh((8, 1), "cpu"))
    with pytest.raises(ValueError, match="halo width"):
        ShardedPipeline(pipe, make_mesh((1, 8), "cpu"), overlap=True)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedPipeline(pipe, make_mesh((1, 7), "cpu"))


def test_sharded_static_coastline(small_case):
    """ci_t = None: one distance transform per run, both structures."""
    c = small_case
    _, (j_state, j_out) = _jax_run(c, (2, 4), ci=False)
    ref_state, ref_out = _port_run(_port(c), c, ci=False)
    for overlap in (True, False):
        got_state, got_out = _port_run(_port(c, (2, 4), overlap=overlap), c,
                                       ci=False)
        _assert_outputs_close(got_out, j_out)
        _assert_state_close(got_state, j_state)
        _assert_outputs_close(got_out, ref_out)
        _assert_state_close(got_state, ref_state)


def test_sharded_3d_pressure(small_case):
    """3-D per-column pressure, split like the fields: overlapped on 2 x 4
    and 4 x 2, basic on 2 x 4."""
    c = small_case
    nlev = len(c["p"])
    rng = np.random.default_rng(21)
    p3 = (c["p"][:, None, None] + 9000.0 * rng.standard_normal(
        (nlev,) + c["lsm"].shape)).astype(np.float32)
    ref_state, ref_out = _port_run(_port(c), c, pres=p3)
    for mesh_shape, overlap in (((2, 4), "auto"), ((4, 2), "auto"),
                                ((2, 4), False)):
        _, (j_state, j_out) = _jax_run(c, mesh_shape, overlap=overlap,
                                       pres=p3)
        sp = _port(c, mesh_shape, overlap=overlap)
        assert sp.overlap is (overlap == "auto")
        got_state, got_out = _port_run(sp, c, pres=p3)
        _assert_outputs_close(got_out, j_out)
        _assert_state_close(got_state, j_state)
        _assert_outputs_close(got_out, ref_out)
        _assert_state_close(got_state, ref_state)


def test_sharded_wind_refresh_on_kernel_path(small_case):
    """From tt = 15 (the 6-hourly refresh) with a random carried state:
    the kernel path (``use_kernels=True``, its wrappers' plain versions on
    the CPU) against the JAX sharded run and the port's single device."""
    c = small_case
    shape = c["lsm"].shape
    rng = np.random.default_rng(3)
    thc0 = (290 + rng.standard_normal(shape)).astype(np.float32)
    ws0 = (5 + rng.random(shape)).astype(np.float32)
    wd0 = (360 * rng.random(shape) - 180).astype(np.float32)
    jstate = JState(tt=jnp.int32(15), thc=jnp.asarray(thc0),
                    windspeed=jnp.asarray(ws0), winddir=jnp.asarray(wd0))
    _, (j_state, j_out) = _jax_run(c, (2, 4), state=jstate)
    state = state_from_numpy(15, thc0, ws0, wd0, "cpu")
    got_state, got_out = _port_run(_port(c, (2, 4), use_kernels=True), c,
                                   state=state)
    assert got_state.tt == 17
    _assert_outputs_close(got_out, j_out)
    _assert_state_close(got_state, j_state)
    np.testing.assert_array_equal(state.windspeed.numpy(), ws0)
    ref_state, ref_out = _port_run(_port(c), c, state=state)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_clean_periodic_mode(small_case):
    """exact_lon_indexing=False: no seam patches, overlapped on 2 x 4."""
    c = small_case
    _, (j_state, j_out) = _jax_run(
        c, (2, 4), params=JParams(exact_lon_indexing=False))
    sp = _port(c, (2, 4), params=Params(exact_lon_indexing=False))
    assert sp.overlap
    got_state, got_out = _port_run(sp, c)
    _assert_outputs_close(got_out, j_out)
    _assert_state_close(got_state, j_state)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_kernel_path_on_cpu_equals_plain_path(small_case, mesh_shape):
    """``use_kernels=True`` on the CPU: B1 through a per-shard
    ``StackedScan`` (2 x 4, overlapped, shards with nonzero row_offset) or
    B4 (1 x 8, basic), B2 and B6, each wrapper taking its plain version;
    bit-equal to ``use_kernels=False`` (plain exchange, plain distance)
    and to the kernel halo backend forced to 'plain'."""
    c = small_case
    kern = _port(c, mesh_shape, use_kernels=True)
    plain = _port(c, mesh_shape, use_kernels=False)
    assert kern.overlap is (mesh_shape == (2, 4))
    assert (kern.halo_backend, plain.halo_backend) == ("kernel", "plain")
    assert (kern.distance_impl, plain.distance_impl) == ("auto", "plain")
    runs = [_port_run(sp, c) for sp in (kern, plain)]
    _assert_bit_equal(*runs[0], *runs[1])
    forced = _port(c, mesh_shape, use_kernels=True, halo_backend="plain")
    _assert_bit_equal(*runs[0], *_port_run(forced, c))


def test_diag_mesh_matches_jax_diag(global_case):
    """``diag(mesh='2x4')`` against the JAX ``diag(mesh=(2, 4))`` and the
    port's ``diag()`` on the global grid (the regional one's measured ring
    radius is too wide for a 2 x 4 mesh, in both packages); the pipeline
    cache keys on the mesh shape."""
    from seabreeze_param_tpu_torch import api
    c = global_case
    args = (1, c["lsm"], c["z"], c["std"], c["lon"], c["lat"], c["p"],
            c["u_t"][:NSTEPS], c["v_t"][:NSTEPS], c["theta_t"][:NSTEPS],
            c["ci_t"][:NSTEPS])
    ref = jdiag(*args, mesh=(2, 4), full_output=True)
    api.clear_exec_cache()
    got = diag(*args, device="cpu", mesh="2x4", full_output=True)
    single = diag(*args, device="cpu", full_output=True)
    assert got[0] == ref[0] == 1 + NSTEPS

    def state(r):
        return SimpleNamespace(tt=r[0], thc=r[2], windspeed=r[3],
                               winddir=r[4])

    for other in (ref, single):
        _assert_outputs_close(got[5], other[5])
        _assert_state_close(state(got), state(other))
    np.testing.assert_array_equal(got[1], got[5]["sb_con"])
    misses = api.CACHE_STATS["pipeline_misses"]
    diag(*args, device="cpu", mesh=(2, 4))
    assert api.CACHE_STATS["pipeline_misses"] == misses
    diag(*args, device="cpu", mesh=(4, 2))
    assert api.CACHE_STATS["pipeline_misses"] == misses + 1


def test_dummy_model_sharded_matches_jax():
    """The dummy model's ``--sharded`` on a 2 x 4 mesh against the JAX
    example's on the 8 virtual devices (its default mesh there)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import dummy_model as jdummy
    jfinal, jsb = jdummy.run(steps=3, sharded=True)
    final, sb = tdummy.run(steps=3, sharded=True, device="cpu", mesh="2x4")
    assert sb.shape == (3, tdummy.NY, tdummy.NX)
    _assert_outputs_close({"sb_con": sb}, {"sb_con": np.asarray(jsb)})
    _assert_state_close(final, jfinal)
    single, ssb = tdummy.run(steps=3, sharded=True, device="cpu", mesh="1x1")
    _assert_outputs_close({"sb_con": sb}, {"sb_con": ssb})


def test_dummy_model_main_sharded(capsys):
    tdummy.main(["--steps=2", "--device=cpu", "--sharded", "--mesh=2x4"])
    out = capsys.readouterr().out
    assert "2 coupled steps on 96x128 (cpu)" in out and "tt=3" in out


def test_sharded_sigmoid_matches_jax_and_float64(global_case):
    """The mesh-wide sigmoid over 2 x 4 shards of the lat-padded global
    grid (122 rows, the padding row left out): within 2e-6 of JAX's
    psum/pmax/pmin form and 1e-6 of a float64 evaluation; and
    ``valid_mask`` on one block against JAX's."""
    std = global_case["std"]
    std_p = np.concatenate([std, std[-1:]], axis=0)
    mesh = make_mesh((2, 4), "cpu")
    shards = split(torch.tensor(std_p), mesh)
    valid = [(torch.arange(r0, r0 + 61) < 121)[:, None]
             for r0 in (0, 0, 0, 0, 61, 61, 61, 61)]
    got = torch.cat([torch.cat(sm[i:i + 4], dim=1)
                     for sm in [sigmoid_weight_shards(shards, valid)]
                     for i in (0, 4)], dim=0).numpy()

    def jfn(x):
        row0 = jax.lax.axis_index("y") * x.shape[0]
        vm = ((row0 + jnp.arange(x.shape[0])) < 121)[:, None]
        return jsigmoid(x, axis_names=("y", "x"), valid_mask=vm)

    ref = np.asarray(jax.jit(jax.shard_map(
        jfn, mesh=jmake_mesh((2, 4)), in_specs=P("y", "x"),
        out_specs=P("y", "x"), check_vma=False))(std_p))
    a = std.astype(np.float64)
    s = 2.0 / np.sqrt(((a - a.mean()) ** 2).sum() / a.size)
    exact = 1.0 / (1.0 + np.exp(-s * (a - (a.max() - a.min()) / 4.0)))
    np.testing.assert_allclose(got[:121], exact, rtol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    # one block with the same mask: the single-device form of valid_mask
    vm = np.arange(122)[:, None] < 121
    one = sigmoid_weight(torch.tensor(std_p),
                         valid_mask=torch.tensor(vm)).numpy()
    np.testing.assert_allclose(one, np.asarray(jsigmoid(std_p,
                                                        valid_mask=vm)),
                               rtol=2e-6)
    np.testing.assert_allclose(one[:121], exact, rtol=1e-6)
