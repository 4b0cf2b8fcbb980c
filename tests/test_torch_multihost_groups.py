"""A multi-process run whose ranks each hold several groups of shards, as a
JAX process holds several devices of a multi-host mesh: two ranks over
``torch.distributed`` (gloo) on the CPU, each with its block of the global
mesh over a list of CPU entries (``make_multihost_mesh(shape, ['cpu'] *
n)``), so the grouped code runs in each rank (per-group exchanges with the
process edges delivered to the groups that read them, statistics gathered
in shard order, outputs gathered to the first group).

Each rank is held bit-equal (``torch.equal``) to one process on the same
global mesh and to one group a rank; the ranks' blocks together to JAX
``TriggerPipeline.run`` within the JAX package's multi-process tolerance
(``tests/test_torch_multihost.py::_outputs_close``).  The ranks import
torch and the port only, and run this file's ``__main__`` through
``tests/test_torch_multihost.py::_spawn``; one launch serves every case
but the driver's, whose resume needs a second.
"""
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_multihost import MISSING, _outputs_close, _spawn, world

#: The global meshes and the groups of each rank's block: 4 x 2 over four
#: entries (a 2 x 2 block, one shard a group: the top groups read the top
#: edge, the bottom ones the bottom edge), 2 x 4 over two (a 1 x 4 block,
#: one mesh row across both groups, so both read both edges).
GROUPINGS = (((4, 2), 4), ((2, 4), 2))
#: The halo widths held: 1-wide, uneven, one-sided and full-shard.
WIDTHS = ((1, 1), (3, 2), (0, 3), (4, 0), (6, 4))
FILLS = (("clamp", True), ("clamp", False), ("zero", False))
#: ``diag``'s global mesh and its groups a rank (its ring radius needs
#: shards of more than 16 rows): a 1 x 2 block, one shard a group.
DIAG_MESH, DIAG_GROUPS = (2, 2), 2


def _run(case, *args):
    return _spawn(case, *args, script=__file__)


# -- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mh_groups")
    return out_dir, _run("groups", out_dir)


def _ok(outs, what):
    for r, out in enumerate(outs):
        assert f"{what} ok {r}" in out, out[-4000:]


def test_default_shape_over_a_device_list(groups):
    """``make_multihost_mesh(device=['cpu'] * 4)`` in two ranks: the JAX
    rule's (4, 2) global mesh (``tests/multihost_worker.py:63``), a 2 x 2
    block of four groups at row ``2 * rank``; an explicit shape whose
    block does not split over the list is refused."""
    _ok(groups[1], "mesh")


def test_halo_exchange_over_groups_bit_equal(groups):
    """Each rank's block over groups, both backends, every width and fill
    (``'clamp'``, ``'zero'``, with and without the seam patches): the
    padded blocks equal one group a rank's and one process's exchange of
    the whole mesh, bit for bit, the process edges from the other rank."""
    for shape, n in GROUPINGS:
        _ok(groups[1], f"halo {shape[0]}x{shape[1]}/{n}")


def test_sigmoid_over_groups_bit_equal(groups):
    """The sigmoid's statistics over groups and ranks, reduced in global
    shard order: each rank's weights equal one process's, bit for bit."""
    _ok(groups[1], "sigmoid")


@pytest.mark.parametrize("shape,n", GROUPINGS)
def test_distributed_runner_over_groups(groups, shape, n):
    """``DistributedRunner.run`` over groups on the 64 x 64 world,
    overlapped and basic: bit-equal to the port's one-process
    ``ShardedPipeline`` on ``make_mesh(shape, 'cpu')`` and to one group a
    rank (checked in the ranks); the ranks' overlapped blocks together
    against JAX ``TriggerPipeline.run``."""
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    out_dir, outs = groups
    tag = f"{shape[0]}x{shape[1]}/{n}"
    _ok(outs, f"runner {tag}")
    blocks = [np.load(out_dir / f"runner.{shape[0]}x{shape[1]}.{r}.npz")
              for r in range(2)]
    got = {k: np.concatenate([b[k] for b in blocks], axis=-2)
           for k in blocks[0].files if k != "tt"}
    lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    ref_state, ref = TriggerPipeline(Grid(lon=lon, lat=lat)).run(
        TriggerState.zeros(lsm.shape), theta, u, v, lsm, z, std, p, ci_t=ci)
    _outputs_close({k: got[k] for k in ref}, ref, f"runner {tag} vs JAX")
    for key in ref:
        r = np.asarray(ref[key])
        keep = r != MISSING
        np.testing.assert_allclose(got[key][keep], r[keep], rtol=2e-5,
                                   atol=2e-4, err_msg=f"{tag} {key}")
    np.testing.assert_allclose(got["final_thc"], np.asarray(ref_state.thc),
                               rtol=1e-6, atol=1e-5)
    assert all(int(b["tt"][0]) == int(ref_state.tt) for b in blocks)


def test_state_checkpoint_of_grouped_blocks(groups):
    """Each rank saves the final state of its grouped block
    (``save_state_sharded``, the rank's block gathered to its first
    group); the whole state restored from both blocks equals one
    process's final state, bit for bit."""
    _ok(groups[1], "checkpoint")


def test_diag_over_groups_bit_equal_to_one_process(groups):
    """``diag(mesh=(2, 2), device=['cpu', 'cpu'], full_output=True)`` in
    both ranks: every return bit-equal to one process's ``diag(mesh=(2,
    2), device='cpu')``."""
    _ok(groups[1], "diag")


def test_cli_driver_over_groups_resumes(tmp_path_factory, tmp_path):
    """The batch driver in two ranks with ``--device=cpu,cpu`` (each rank's
    block over two groups of the default (2, 2) mesh) and a checkpoint
    directory: a first launch over the first day, a relaunch over both
    that resumes at the second; rank 0's two files are bit-equal to one
    process's ``--mesh=2x2`` driver, and the first is not rewritten."""
    from seabreeze_param_tpu_torch.cli.run import main
    from seabreeze_param_tpu_torch.io import Dataset
    from tests.test_io import _build_synthetic_run
    ref = _build_synthetic_run(tmp_path_factory.mktemp("mhg_ref"), nlat=160,
                               nlon=288, nt=2)
    mh = _build_synthetic_run(tmp_path_factory.mktemp("mhg"), nlat=160,
                              nlon=288, nt=2)
    written_ref = main(str(ref["conf"]), progress=None, device="cpu",
                       mesh=(2, 2))[-1]
    assert len(written_ref) == 2
    first = tmp_path / "first_day.conf"
    first.write_text(mh["conf"].read_text().replace(
        "end = 1987-01-03_00:00", "end = 1987-01-02_00:00"))
    ck = tmp_path / "ck"
    files = [f.replace(str(ref["root"]), str(mh["root"]))
             for f in written_ref]
    _run("cli", first, ck)
    assert os.path.isfile(files[0]) and not os.path.exists(files[1])
    stamp = os.stat(files[0]).st_mtime_ns
    _run("cli", mh["conf"], ck)
    assert os.stat(files[0]).st_mtime_ns == stamp
    for f_ref, f in zip(written_ref, files):
        with Dataset(f_ref) as a, Dataset(f) as b:
            for key in ("sb_con", "thc"):
                np.testing.assert_array_equal(np.ma.getdata(
                    b.variables[key][:]), np.ma.getdata(a.variables[key][:]),
                    err_msg=f"{f} {key}")


@pytest.mark.parametrize("nproc,per", [(1, 1), (2, 1), (2, 2), (2, 4),
                                       (4, 2), (1, 8)])
def test_multihost_shape_matches_jax(monkeypatch, nproc, per):
    """The port's default global shape equals JAX ``make_multihost_mesh``
    over ``nproc`` processes of ``per`` devices each (the conftest's 8
    virtual devices, ``jax.process_count`` and ``jax.devices``
    monkeypatched); both refuse a lat axis that does not split over the
    processes, with the same message."""
    import jax
    from seabreeze_param_tpu.parallel import distributed as jdist
    from seabreeze_param_tpu_torch.parallel.distributed import multihost_shape
    devices = jax.devices()[:nproc * per]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    mesh = jdist.make_multihost_mesh()
    assert multihost_shape(nproc, per) == (mesh.shape["y"], mesh.shape["x"])
    if nproc > 1:
        shape = (nproc + 1, 1)
        with pytest.raises(ValueError) as want:
            jdist.make_multihost_mesh(shape)
        with pytest.raises(ValueError) as got:
            multihost_shape(nproc, per, shape)
        assert str(got.value) == str(want.value)


def test_multihost_shape_refuses_uneven_blocks():
    """An explicit shape whose block does not split evenly over the
    process's devices is refused with ``make_mesh``'s message; one that
    does takes several shards an entry."""
    from seabreeze_param_tpu_torch.parallel.distributed import multihost_shape
    with pytest.raises(ValueError, match=r"\(2, 3\): 3 shards do not split "
                                         r"evenly over 2 devices"):
        multihost_shape(2, 2, (2, 3))
    with pytest.raises(ValueError, match="over 4 devices"):
        multihost_shape(2, 4, "2x2")
    assert multihost_shape(2, 2, "4x4") == (4, 4)
    assert multihost_shape(2, 1) == (2, 1)


def test_group_edges_by_row_and_card():
    """Which process edges each group of a block reads: in a 2 x 2 block of
    four groups the top row's groups the top edge and the bottom row's the
    bottom; in a 1 x 4 block both groups both; a group on a device with no
    copy of an edge it reads is refused, and without process edges every
    group reads none."""
    from seabreeze_param_tpu_torch.parallel.halo import group_edges
    from seabreeze_param_tpu_torch.parallel.mesh import ShardMesh
    cpu = torch.device("cpu")
    top, bot = torch.zeros(2, 8), torch.ones(2, 8)
    edges = {cpu: (top, bot)}
    mesh = ShardMesh(2, 2, cpu, rank=1, world=3, devices=(cpu,) * 4)
    got = [group_edges(edges, mesh, g) for g in range(4)]
    assert [tuple(e is not None for e in pair) for pair in got] == [
        (True, False), (True, False), (False, True), (False, True)]
    assert got[0][0] is top and got[3][1] is bot
    row = ShardMesh(1, 4, cpu, rank=1, world=3, devices=(cpu,) * 2)
    assert all(group_edges(edges, row, g) == (top, bot) for g in range(2))
    assert group_edges({cpu: (None, bot)}, row, 0) == (None, bot)
    assert group_edges(None, mesh, 0) == group_edges({}, row, 1) == (
        None, None)
    with pytest.raises(ValueError, match="top process edge"):
        group_edges({torch.device("meta"): (top, None)}, mesh, 1)


# -- the ranks' side -----------------------------------------------------------
def _rank_groups(out_dir):
    import tempfile
    from seabreeze_param_tpu_torch.core import checkpoint
    from seabreeze_param_tpu_torch.core.grid import Grid
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.ops.orography import sigmoid_weight_shards
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.halo import (halo_exchange_plain,
                                                         halo_pad)
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh, split
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    r = dist.rank()
    mesh = dist.make_multihost_mesh(device=["cpu"] * 4)
    assert (mesh.global_shape, mesh.shape, mesh.groups, mesh.row0) == (
        (4, 2), (2, 2), 4, 2 * r)
    try:
        dist.make_multihost_mesh((2, 2), ["cpu"] * 4)
    except ValueError as e:
        assert "2 shards do not split evenly over 4 devices" in str(e)
    else:
        raise AssertionError("a block of 2 shards over 4 entries accepted")
    print(f"mesh ok {r}", flush=True)

    rng = np.random.default_rng(5)
    field = torch.as_tensor(rng.random((2, 24, 20), np.float32))
    std = torch.as_tensor(120 * rng.random((22, 20), np.float32))
    padded = std[torch.arange(24).clamp(max=21)]
    for shape, n in GROUPINGS:
        tag = f"{shape[0]}x{shape[1]}/{n}"
        one = make_mesh(shape, "cpu")
        mesh = dist.make_multihost_mesh(shape, ["cpu"] * n)
        flat = dist.make_multihost_mesh(shape, "cpu")
        assert mesh.groups == n and flat.groups == 1
        size = mesh.size
        everyone = split(field, one)
        mine, mine_flat = (split(field[..., 12 * r:12 * r + 12, :], m)
                           for m in (mesh, flat))
        for hy, hx in WIDTHS:
            for fill, exact in FILLS:
                kw = dict(lat_fill=fill, exact_lon=exact)
                ref = halo_exchange_plain(everyone, one, hy, hx,
                                          **kw)[size * r:size * (r + 1)]
                want = halo_pad(mine_flat, flat, hy, hx, **kw)
                for backend in ("kernel", "plain"):
                    got = halo_pad(mine, mesh, hy, hx, backend=backend, **kw)
                    for g, w, x in zip(got, want, ref):
                        assert torch.equal(g, w) and torch.equal(g, x), (
                            tag, hy, hx, fill, exact, backend)
        print(f"halo {tag} ok {r}", flush=True)

        h = 24 // shape[0]
        valid = [(torch.arange(h * iy, h * iy + h) < 22)[:, None]
                 for iy in range(shape[0]) for _ in range(shape[1])]
        ref = sigmoid_weight_shards(split(padded, one),
                                    valid)[size * r:size * (r + 1)]
        got = sigmoid_weight_shards(split(padded[12 * r:12 * r + 12], mesh),
                                    valid[size * r:size * (r + 1)],
                                    dist.all_gather_cat)
        assert all(torch.equal(g, w) for g, w in zip(got, ref)), tag
    print(f"sigmoid ok {r}", flush=True)

    lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    pipe = TriggerPipeline(Grid(lon=lon, lat=lat), device="cpu")
    zeros = TriggerState.zeros(lsm.shape, "cpu")
    for shape, n in GROUPINGS:
        tag = f"{shape[0]}x{shape[1]}"
        for overlap in (True, False):
            sp = ShardedPipeline(pipe, dist.make_multihost_mesh(
                shape, ["cpu"] * n), overlap=overlap)
            runs = []
            for runner in (dist.DistributedRunner(sp), dist.DistributedRunner(
                    ShardedPipeline(pipe, dist.make_multihost_mesh(
                        shape, "cpu"), overlap=overlap))):
                lo, hi = runner.row_lo, runner.row_hi

                def slab(a):
                    return np.asarray(a)[..., lo:hi, :]

                runs.append(runner.run(
                    TriggerState(zeros.tt, *(slab(getattr(zeros, f)) for f in
                                             ("thc", "windspeed", "winddir"))),
                    slab(theta), slab(u), slab(v), slab(lsm), slab(z),
                    slab(std), p, ci_t=slab(ci)))
            rstate, ref = ShardedPipeline(pipe, make_mesh(shape, "cpu"),
                                          overlap=overlap).run(
                zeros, theta, u, v, lsm, z, std, p, ci_t=ci)
            grouped = runs[0]
            for final, outs in runs:
                for key in ref:
                    assert torch.equal(outs[key], ref[key][:, lo:hi]), key
                for f in ("thc", "windspeed", "winddir"):
                    assert torch.equal(getattr(final, f),
                                       getattr(rstate, f)[lo:hi]), f
                assert final.tt == rstate.tt
            if overlap:
                final, outs = grouped
                np.savez(os.path.join(out_dir, f"runner.{tag}.{r}.npz"),
                         final_thc=final.thc.numpy(),
                         tt=np.array([final.tt]),
                         **{k: o.numpy() for k, o in outs.items()})
        print(f"runner {tag}/{n} ok {r}", flush=True)

    # the last grouped run's final state, the rank's rows [lo, hi)
    final = grouped[0]
    d = [tempfile.mkdtemp() if r == 0 else None]
    torch.distributed.broadcast_object_list(d, 0)
    assert checkpoint.save_state_sharded(d[0], final, lo) == final.tt
    whole = checkpoint.restore_state_sharded(d[0], 0, 64)
    for f in ("thc", "windspeed", "winddir"):
        np.testing.assert_array_equal(getattr(whole, f),
                                      getattr(rstate, f).numpy())
    assert whole.tt == rstate.tt
    print(f"checkpoint ok {r}", flush=True)


def _rank_main(case, *args):
    torch.set_num_threads(2)
    if case == "groups":
        # one process's diag on the same global mesh, before the group exists
        from seabreeze_param_tpu_torch.api import diag
        lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
        diag_args = (1, lsm, z, std, lon, lat, p, u, v, theta, ci)
        ref = diag(*diag_args, device="cpu", full_output=True,
                   mesh=DIAG_MESH)
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    dist.initialize()
    assert dist.world_size() == 2
    if case == "groups":
        _rank_groups(*args)
        got = diag(*diag_args, device=["cpu"] * DIAG_GROUPS,
                   full_output=True, mesh=DIAG_MESH)
        assert got[0] == ref[0]
        for i in range(1, 5):
            np.testing.assert_array_equal(got[i], ref[i])
        for key in ref[5]:
            np.testing.assert_array_equal(got[5][key], ref[5][key])
        print(f"diag ok {dist.rank()}", flush=True)
    elif case == "cli":
        from seabreeze_param_tpu_torch.cli.run import cli
        conf, ckpt_dir = args
        cli([f"--config={conf}", "--device=cpu,cpu", f"--ckpt_dir={ckpt_dir}"])
    dist.barrier()
    print(f"TORCH-MULTIHOST-OK {case} {dist.rank()}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
