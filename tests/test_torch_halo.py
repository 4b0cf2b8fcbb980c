"""The port's halo exchange over shard lists (``parallel/halo.py``, kernel
B6's plain version, which B6's wrapper takes for CPU tensors) against the
JAX package's ``halo_pad`` under ``shard_map`` on the same mesh of virtual
CPU devices, bit for bit; one case also against the JAX DMA kernel
``halo_exchange_dma`` under ``pltpu.InterpretParams`` (as
``tests/test_halo_dma.py`` runs it).  Plus the shard-mesh helpers, the
width guard and the 1-wide mesh axes."""
import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from seabreeze_param_tpu.ops.pallas.halo_kernel import halo_exchange_dma
from seabreeze_param_tpu.parallel import halo as jhalo
from seabreeze_param_tpu.parallel.mesh import make_mesh as jmake_mesh
from seabreeze_param_tpu_torch.ops.cuda.halo_kernel import halo_exchange_cuda
from seabreeze_param_tpu_torch.ops.distance import pad_coast
from seabreeze_param_tpu_torch.ops.indexing import pad2d
from seabreeze_param_tpu_torch.parallel import halo as thalo
from seabreeze_param_tpu_torch.parallel.mesh import (ShardMesh, gather,
                                                     make_mesh, split)

FILLS = [("clamp", True), ("clamp", False), ("zero", False)]
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]


def _field(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_exchange(field, mesh_shape, hy, hx, fn):
    """``fn(local)`` under shard_map on the JAX mesh; the padded blocks
    laid side by side, as :func:`gather` lays the port's."""
    spec = P(*([None] * (field.ndim - 2)), "y", "x")
    run = jax.jit(jax.shard_map(fn, mesh=jmake_mesh(mesh_shape),
                                in_specs=spec, out_specs=spec,
                                check_vma=False))
    return np.asarray(run(field))


def _port_exchange(field, mesh_shape, hy, hx, **kw):
    mesh = make_mesh(mesh_shape, "cpu")
    padded = thalo.halo_pad(split(torch.tensor(field), mesh), mesh, hy, hx,
                            **kw)
    return gather(padded, mesh).numpy()


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("lat_fill,exact_lon", FILLS)
def test_plain_exchange_matches_jax_halo_pad(mesh_shape, lat_fill,
                                             exact_lon):
    """One-shot plain exchange, 3-wide, against JAX ``halo_pad``."""
    field = _field((48, 64))
    ref = _jax_exchange(field, mesh_shape, 3, 3, lambda x: jhalo.halo_pad(
        x, 3, 3, lat_fill=lat_fill, exact_lon=exact_lon))
    got = _port_exchange(field, mesh_shape, 3, 3, lat_fill=lat_fill,
                         exact_lon=exact_lon, backend="plain")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lat_fill,exact_lon", FILLS)
@pytest.mark.parametrize("hy,hx", [(1, 1), (2, 5), (6, 0), (0, 4)])
def test_two_channel_split_phase_matches_jax(lat_fill, exact_lon, hy, hx):
    """A (2, h, w) input (the ring inputs' shape) through the split-phase
    API, both backends (the kernel backend takes B6's plain version on the
    CPU), against JAX ``halo_pad``; uneven and one-sided widths."""
    field = _field((2, 48, 64), seed=9)
    ref = _jax_exchange(field, (2, 4), hy, hx, lambda x: jhalo.halo_pad(
        x, hy, hx, lat_fill=lat_fill, exact_lon=exact_lon))
    mesh = make_mesh((2, 4), "cpu")
    local = split(torch.tensor(field), mesh)
    for backend in ("plain", "kernel"):
        parts = thalo.halo_start(local, mesh, hy, hx, lat_fill=lat_fill,
                                 exact_lon=exact_lon, backend=backend)
        got = gather(thalo.halo_finish(parts), mesh).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=backend)


def test_plain_exchange_matches_jax_dma_kernel():
    """The port's exchange against the JAX DMA kernel itself, in interpret
    mode, on a 2 x 4 mesh with the quirky seam."""
    field = _field((48, 64), seed=3)
    ref = _jax_exchange(field, (2, 4), 4, 4, lambda x: halo_exchange_dma(
        x, 4, 4, lat_fill="clamp", exact_lon=True,
        interpret=pltpu.InterpretParams()))
    got = _port_exchange(field, (2, 4), 4, 4, lat_fill="clamp",
                         exact_lon=True)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lat_fill,exact_lon", FILLS)
def test_one_by_one_mesh_equals_single_device_pad(lat_fill, exact_lon):
    """A 1 x 1 mesh (both axes 1-wide): lon is its own neighbour, lat has
    none, so the exchange is the single-device boundary pad — ``pad2d``
    for 'clamp', ``pad_coast``'s zero rows and periodic columns for
    'zero'."""
    field = torch.tensor(_field((20, 30), seed=2))
    mesh = make_mesh((1, 1), "cpu")
    got = thalo.halo_pad([field], mesh, 4, 4, lat_fill=lat_fill,
                         exact_lon=exact_lon)[0]
    want = (pad2d(field, 4, 4, exact_lon=exact_lon) if lat_fill == "clamp"
            else pad_coast(field, 4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_width_guard_and_refusals():
    """A halo wider than the shard, a wrong shard count, shards of
    different shapes and an unknown fill are refused by both backends;
    the full shard width is taken; ``swap_bounds`` is the symmetric
    ``halo_pad``."""
    mesh = make_mesh((2, 2), "cpu")
    local = split(torch.zeros(8, 12), mesh)
    for backend in ("plain", "kernel"):
        with pytest.raises(ValueError, match="wider than"):
            thalo.halo_pad(local, mesh, 5, 1, backend=backend)
        with pytest.raises(ValueError, match="wider than"):
            thalo.halo_pad(local, mesh, 1, 7, backend=backend)
        with pytest.raises(ValueError, match="shards for"):
            thalo.halo_pad(local[:3], mesh, 1, 1, backend=backend)
        with pytest.raises(ValueError, match="different shapes"):
            thalo.halo_pad(local[:3] + [torch.zeros(4, 5)], mesh, 1, 1,
                           backend=backend)
        with pytest.raises(ValueError, match="lat_fill"):
            thalo.halo_pad(local, mesh, 1, 1, lat_fill="wrap",
                           backend=backend)
    assert thalo.halo_pad(local, mesh, 4, 6, exact_lon=False)[0].shape == (
        12, 18)
    for a, b in zip(thalo.swap_bounds(local, mesh, 3),
                    thalo.halo_pad(local, mesh, 3, 3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        thalo.halo_pad(local, mesh, 1, 1, backend="ppermute")
    before = halo_exchange_cuda.launches
    halo_exchange_cuda(local, mesh, 1, 1)
    assert halo_exchange_cuda.launches == before   # CPU: the plain version


def test_mesh_helpers():
    """make_mesh shapes, split/gather round trip (copies, never views), the
    refusal of a device set of several cards."""
    assert make_mesh("2x4", "cpu").shape == (2, 4)
    assert make_mesh((4, 2), "cpu").shape == (4, 2)
    auto = make_mesh(None, "cpu")
    assert auto.shape == (1, 1) and auto.device == torch.device("cpu")
    assert make_mesh("auto", ["cpu", "cpu"]).shape == (1, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh((1, 2), ["cpu", "meta"])
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh((0, 2), "cpu")
    mesh = ShardMesh(3, 2, torch.device("cpu"))
    field = torch.arange(2 * 9 * 8, dtype=torch.float32).reshape(2, 9, 8)
    shards = split(field, mesh)
    assert [s.shape for s in shards] == [(2, 3, 4)] * 6
    assert all(s.is_contiguous() for s in shards)
    torch.testing.assert_close(shards[3], field[:, 3:6, 4:8])
    torch.testing.assert_close(gather(shards, mesh), field, rtol=0, atol=0)
    whole = split(field, ShardMesh(1, 1, torch.device("cpu")))[0]
    whole += 1
    assert field[0, 0, 0] == 0
    with pytest.raises(ValueError, match="divide"):
        split(torch.zeros(7, 8), mesh)
