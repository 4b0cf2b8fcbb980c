"""A mesh over several devices (``parallel/mesh.py``: one group of shards
per device entry), on the CPU: ``make_mesh`` by the JAX package's rule over
a device list, and the grouped mesh — CPU entries named several times, so
the cross-group code runs (per-group exchanges, per-device tables,
statistics gathered in shard order, outputs gathered to the first device)
— bit-equal to the one-group mesh and held to the JAX package's
multi-device run on the conftest's 8 virtual CPU devices: the halo
exchange, the sigmoid, ``ShardedPipeline`` in both structures, ``diag``,
and the dummy model."""
import warnings

import numpy as np
import pytest
import torch

from seabreeze_param_tpu.api import diag as jdiag
from seabreeze_param_tpu.parallel import halo as jhalo
from seabreeze_param_tpu_torch.api import diag
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.examples import dummy_model as tdummy
from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
from seabreeze_param_tpu_torch.ops.orography import sigmoid_weight_shards
from seabreeze_param_tpu_torch.parallel import halo as thalo
from seabreeze_param_tpu_torch.parallel.mesh import (ShardMesh, gather,
                                                     make_mesh, source_groups,
                                                     split)
from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline
from tests.test_torch_halo import FILLS, _field, _jax_exchange
from tests.test_torch_sharded import (NSTEPS, _assert_bit_equal,
                                      _assert_outputs_close,
                                      _assert_state_close, _jax_run,
                                      _port_run)

CPU = torch.device("cpu")


def _grouped(shape, groups):
    """A ``shape`` mesh over ``groups`` CPU entries."""
    return make_mesh(shape, ["cpu"] * groups)


@pytest.mark.parametrize("n,shape,want", [
    (4, None, (2, 2)), (8, "auto", (2, 4)), (2, None, (1, 2)),
    (6, None, (2, 3)), (3, None, (1, 3)), (4, "2x4", (2, 4)),
    (2, (4, 1), (4, 1))])
def test_make_mesh_over_a_list(n, shape, want):
    """The JAX rule: ``'auto'`` is the near-square factorisation of the
    list's length, one shard per entry; an explicit shape of S shards puts
    S / n contiguous row-major shards on each entry."""
    mesh = make_mesh(shape, ["cpu"] * n)
    assert mesh.shape == want and mesh.groups == n
    assert mesh.devices == (CPU,) * n and mesh.device == CPU
    per = mesh.size // n
    assert [mesh.group_of(s) for s in range(mesh.size)] == [
        s // per for s in range(mesh.size)]
    assert [list(mesh.group_shards(g)) for g in range(n)] == [
        list(range(g * per, (g + 1) * per)) for g in range(n)]
    assert all(mesh.device_of(s) == CPU for s in range(mesh.size))


def test_make_mesh_list_refusals_and_subsetting():
    """Fewer shards than entries warn (as JAX does) and take the first
    ones; shards that do not split evenly, a list mixing device types and
    an empty list are refused; a multi-process block may hold several
    groups; a single device is the one-group mesh, as before."""
    with pytest.warns(UserWarning, match="uses only 2 of 4"):
        mesh = make_mesh((1, 2), ["cpu"] * 4)
    assert mesh.groups == 2 and mesh.shape == (1, 2)
    with pytest.raises(ValueError, match=r"\(2, 3\).*4 devices"):
        make_mesh((2, 3), ["cpu"] * 4)
    with pytest.raises(ValueError, match="mixes device types"):
        make_mesh((1, 2), ["cpu", "meta"])
    with pytest.raises(ValueError, match="empty"):
        make_mesh((1, 1), [])
    with pytest.raises(ValueError, match="equal groups"):
        ShardMesh(1, 3, CPU, devices=(CPU, CPU))
    block = ShardMesh(2, 2, CPU, rank=0, world=2, devices=(CPU, CPU))
    assert block.groups == 2 and block.global_shape == (4, 2)
    one = make_mesh("2x4", "cpu")
    assert one.groups == 1 and one.devices == (CPU,)
    assert one == ShardMesh(2, 4, CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_mesh("2x2", ["cpu"] * 4).groups == 4


def test_source_groups():
    """The groups an exchange into a group's shards reads: the eight
    neighbours of each shard, lon ringed, lat clamped."""
    mesh = _grouped((4, 1), 4)
    assert [source_groups(mesh, g) for g in range(4)] == [
        (0, 1), (0, 1, 2), (1, 2, 3), (2, 3)]
    mesh = _grouped((2, 4), 4)          # two shards a group, row-major
    assert source_groups(mesh, 0) == (0, 1, 2, 3)
    mesh = _grouped((1, 4), 2)
    assert source_groups(mesh, 0) == (0, 1)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("lat_fill,exact_lon", FILLS)
def test_grouped_halo_matches_one_group_and_jax(shape, groups, lat_fill,
                                                exact_lon):
    """The exchange over groups, both backends and the split-phase API,
    one and two channels, bit-equal to the one-group mesh and to JAX
    ``halo_pad`` under ``shard_map`` on the same mesh shape."""
    field = _field((2, 48, 64), seed=groups)
    kw = dict(lat_fill=lat_fill, exact_lon=exact_lon)
    ref = _jax_exchange(field, shape, 3, 2, lambda x: jhalo.halo_pad(
        x, 3, 2, **kw))
    one = make_mesh(shape, "cpu")
    mesh = _grouped(shape, groups)
    for f in (field, field[0]):
        t = torch.tensor(f)
        want = thalo.halo_pad(split(t, one), one, 3, 2, **kw)
        for backend in ("plain", "kernel"):
            parts = thalo.halo_start(split(t, mesh), mesh, 3, 2,
                                     backend=backend, **kw)
            got = thalo.halo_finish(parts)
            for g, r in zip(got, want):
                assert torch.equal(g, r), backend
        if f.ndim == 3:
            np.testing.assert_array_equal(gather(got, mesh).numpy(), ref)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_sigmoid_bit_equal_to_one_group(global_case, groups):
    """The mesh-wide sigmoid over 2 x 4 shards of the lat-padded global
    grid in ``groups`` groups: bit-equal to one group."""
    std = global_case["std"]
    std_p = torch.tensor(np.concatenate([std, std[-1:]], axis=0))
    valid = [(torch.arange(r0, r0 + 61) < 121)[:, None]
             for r0 in (0, 0, 0, 0, 61, 61, 61, 61)]
    want = sigmoid_weight_shards(split(std_p, make_mesh((2, 4), "cpu")),
                                 valid)
    mesh = _grouped((2, 4), groups)
    got = sigmoid_weight_shards(split(std_p, mesh), valid)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


_JAX_RUNS = {}


def _jax_sharded(c, shape, overlap):
    if (shape, overlap) not in _JAX_RUNS:
        _JAX_RUNS[shape, overlap] = _jax_run(c, shape, overlap=overlap)[1]
    return _JAX_RUNS[shape, overlap]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("use_kernels", [None, True])
def test_grouped_sharded_pipeline(small_case, overlap, groups, use_kernels):
    """``ShardedPipeline`` over 2 x 2 shards in ``groups`` groups, both
    structures, on the plain path and the kernel path (each wrapper's
    plain version here): bit-equal to the one-group mesh and within the
    sharded tolerances of the JAX package's run on 4 devices."""
    c = small_case
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]), device="cpu",
                           use_kernels=use_kernels)
    one = ShardedPipeline(pipe, make_mesh((2, 2), "cpu"), overlap=overlap)
    sp = ShardedPipeline(pipe, _grouped((2, 2), groups), overlap=overlap)
    assert sp.overlap is overlap and sp.mesh.groups == groups
    got = _port_run(sp, c)
    _assert_bit_equal(*got, *_port_run(one, c))
    j_state, j_out = _jax_sharded(c, (2, 2), overlap)
    _assert_outputs_close(got[1], j_out)
    _assert_state_close(got[0], j_state)


def test_grouped_sharded_static_coastline_and_padding(global_case):
    """No sea ice (one distance transform per run) on the global grid,
    whose 121 rows pad to 122 on a 2 x 4 mesh, over 8 groups and over 2:
    bit-equal to one group."""
    c = global_case
    pipe = TriggerPipeline(Grid(lon=c["lon"], lat=c["lat"]), device="cpu")
    runs = [_port_run(ShardedPipeline(pipe, mesh), c, ci=False)
            for mesh in (make_mesh((2, 4), "cpu"), _grouped((2, 4), 8),
                         _grouped((2, 4), 2))]
    assert runs[0][1]["sb_con"].shape == (NSTEPS, 121, 240)
    for run in runs[1:]:
        _assert_bit_equal(*run, *runs[0])


@pytest.mark.parametrize("devices,mesh", [(["cpu"] * 8, "auto"),
                                          (["cpu"] * 4, "2x4")])
def test_grouped_diag_matches_jax_diag(global_case, devices, mesh):
    """``diag(mesh=..., device=[...])`` against the JAX ``diag(mesh=(2,
    4))`` on its 8 virtual devices, and bit-equal to the port's one-group
    ``diag(mesh='2x4', device='cpu')``; the pipeline cache keys on the
    devices."""
    from seabreeze_param_tpu_torch import api
    c = global_case
    args = (1, c["lsm"], c["z"], c["std"], c["lon"], c["lat"], c["p"],
            c["u_t"][:NSTEPS], c["v_t"][:NSTEPS], c["theta_t"][:NSTEPS],
            c["ci_t"][:NSTEPS])
    ref = jdiag(*args, mesh=(2, 4), full_output=True)
    api.clear_exec_cache()
    one = diag(*args, device="cpu", mesh="2x4", full_output=True)
    misses = api.CACHE_STATS["pipeline_misses"]
    got = diag(*args, device=devices, mesh=mesh, full_output=True)
    assert api.CACHE_STATS["pipeline_misses"] == misses + 1
    assert got[0] == ref[0] == one[0] == 1 + NSTEPS
    for a, b in zip(got[1:5], one[1:5]):
        np.testing.assert_array_equal(a, b)
    _assert_outputs_close(got[5], ref[5])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-5)


def test_dummy_model_over_groups():
    """The dummy model's ``--sharded`` over a device list (the CLI's
    ``--device=cpu,cpu``): bit-equal to one group."""
    final, sb = tdummy.run(steps=2, sharded=True, device=["cpu", "cpu"],
                           mesh="2x4")
    one_final, one_sb = tdummy.run(steps=2, sharded=True, device="cpu",
                                   mesh="2x4")
    assert torch.equal(sb, one_sb)
    for f in ("thc", "windspeed", "winddir"):
        assert torch.equal(getattr(final, f), getattr(one_final, f))


def test_dummy_model_main_device_list(capsys):
    tdummy.main(["--steps=1", "--device=cpu,cpu", "--sharded", "--mesh=2x2"])
    assert "1 coupled steps on 96x128 (cpu,cpu)" in capsys.readouterr().out
