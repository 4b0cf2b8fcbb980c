"""The port's multi-process run: two processes over ``torch.distributed``
(gloo) on the CPU, against one process and against the JAX package.

Each test spawns two ranks running this file's ``__main__`` with the
launcher variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  The ranks import torch and the
port only; JAX is imported by the tests in this process.  Each wait on a
rank has its own timeout, and on expiry both ranks are killed, so a
deadlock fails one test.  Tolerance against the JAX package, as its own
``tests/test_multihost.py`` (``multihost_worker.py``): the MISSING
structure equal, fewer than 1e-3 of cells outside rtol 1e-5 / atol 1e-4,
the final thc within rtol 1e-6 / atol 1e-5, tt equal.  Against one
process of the port on the same global mesh: bit-equal.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISSING = np.float32(2.0e20)
#: Seconds each rank may take, per launch.
TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(case, *args, nproc=2, script=__file__):
    """Run ``case`` in ``nproc`` ranks of ``script``'s ``__main__`` (this
    file's by default); returns their outputs, after asserting that each
    exited 0 and printed its OK line."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE=str(nproc),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), case,
         *(str(a) for a in args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"TORCH-MULTIHOST-OK {case} {r}" in out, out[-4000:]
    return outs


def world(nt=2):
    """The 64 x 64 world of the JAX package's two-process test
    (``tests/multihost_worker.py``), built the same way from seed 42, with
    sea ice appearing at step 1."""
    F = np.float32
    nlat, nlon, nlev = 64, 64, 4
    lat = np.linspace(7.0, -24.5, nlat).astype(F)
    lon = np.linspace(100.0, 132.0, nlon, endpoint=False).astype(F)
    rng = np.random.default_rng(42)
    y, x = np.mgrid[0:nlat, 0:nlon]
    coastx = 0.55 * nlon + 0.08 * nlon * np.sin(2 * np.pi * y / nlat * 2.3)
    land = (x > coastx).astype(F)
    lsm = (land * (0.6 + 0.4 * rng.random((nlat, nlon)))).astype(F)
    z = (800.0 * lsm * rng.random((nlat, nlon))).astype(F)
    std = (120.0 * lsm * rng.random((nlat, nlon))).astype(F)
    p = np.array([100000.0, 92500.0, 85000.0, 70000.0], F)[:nlev]
    theta = (288.0 + 8.0 * rng.standard_normal((nt, nlat, nlon))).astype(F)
    u = (6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    v = (6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    ci = np.zeros((nt, nlat, nlon), F)
    ci[1:, :6, :] = 0.9
    return lon, lat, (lsm, z, std, p, theta, u, v, ci)


def process_block(field, mesh_shape, world, rank, hy, device="cpu",
                  devices=None):
    """Process ``rank``'s block of a ``world``-process split of a global
    mesh, over ``devices`` (one group of shards per entry; default one
    group on ``device``): its shards, each on its group's device, its
    :class:`ShardMesh` and the edges that ``exchange_edges`` would deliver
    for a halo of ``hy`` rows, ``{device: (top, bot)}``, the rows the
    neighbouring processes would send, a copy on each of the block's
    devices."""
    import torch
    from seabreeze_param_tpu_torch.parallel.mesh import ShardMesh, split
    py, px = mesh_shape
    h = field.shape[-2] // py
    local_py = py // world
    mesh = ShardMesh(local_py, px, torch.device(device), rank, world,
                     devices=tuple(devices or (device,)))
    one = ShardMesh(py, px, mesh.device)
    shards = [x.to(mesh.device_of(s)) for s, x in enumerate(
        split(field, one)[rank * local_py * px:(rank + 1) * local_py * px])]
    lo, hi = rank * local_py * h, (rank + 1) * local_py * h
    top = (field[..., lo - hy:lo, :].contiguous() if rank > 0 and hy
           else None)
    bot = (field[..., hi:hi + hy, :].contiguous() if rank < world - 1 and hy
           else None)
    return shards, mesh, {dev: tuple(None if e is None else e.to(dev)
                                     for e in (top, bot))
                          for dev in dict.fromkeys(mesh.devices)}


def _outputs_close(got, ref, what):
    """The JAX package's multi-process tolerance."""
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, (what, key, g.shape, r.shape)
        miss = r == MISSING
        np.testing.assert_array_equal(g == MISSING, miss, err_msg=key)
        off = ~np.isclose(g[~miss], r[~miss], rtol=1e-5, atol=1e-4)
        assert off.mean() < 1e-3, f"{what} {key}: {off.sum()}/{off.size}"


# -- the parent's side ---------------------------------------------------------
@pytest.fixture(scope="module")
def units():
    return _spawn("units")


def test_halo_exchange_across_ranks_bit_equal(units):
    """Every exchange width, fill and backend: each rank's padded blocks
    equal one process's on the same global mesh, bit for bit, the process
    edge's rows coming from the other rank."""
    for r, out in enumerate(units):
        assert f"halo ok {r}" in out, out[-4000:]


def test_sigmoid_across_ranks_bit_equal(units):
    """The sigmoid's statistics gathered over both ranks: each rank's
    weights equal one process's, bit for bit, padding rows left out."""
    for r, out in enumerate(units):
        assert f"sigmoid ok {r}" in out, out[-4000:]


def test_save_state_sharded_round_trip(units):
    """Each rank saves its row block, restores its own rows, and the whole
    state restores from the two blocks; no checkpoint gives None."""
    for r, out in enumerate(units):
        assert f"sharded checkpoint ok {r}" in out, out[-4000:]


def test_make_multihost_mesh_refuses_uneven_split(units):
    """A global mesh whose rows do not split evenly over the ranks is
    refused with the JAX package's message; (2*a) x b splits."""
    for r, out in enumerate(units):
        assert f"mesh ok {r}" in out, out[-4000:]


def test_distributed_runner_matches_single_process_and_jax(tmp_path):
    """``DistributedRunner.run`` on the 64 x 64 world over a 4 x 2 global
    mesh, each rank fed its own rows: bit-equal to the port's one-process
    ``ShardedPipeline`` (overlapped and basic structures, and 63 rows on 2
    x 2, where the last rank pads a row; checked in the ranks), and the
    ranks' blocks together against JAX ``TriggerPipeline.run``."""
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    _spawn("runner", tmp_path)
    blocks = [np.load(tmp_path / f"runner.{r}.npz") for r in range(2)]
    got = {k: np.concatenate([b[k] for b in blocks], axis=-2)
           for k in blocks[0].files if k != "tt"}
    lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    ref_state, ref = TriggerPipeline(Grid(lon=lon, lat=lat)).run(
        TriggerState.zeros(lsm.shape), theta, u, v, lsm, z, std, p, ci_t=ci)
    _outputs_close({k: got[k] for k in ref}, ref, "runner vs JAX")
    np.testing.assert_allclose(got["final_thc"], np.asarray(ref_state.thc),
                               rtol=1e-6, atol=1e-5)
    assert all(int(b["tt"][0]) == int(ref_state.tt) for b in blocks)


#: The nearest lon form's world: :func:`world`'s fields on a global lon
#: axis (64 columns, 5.625 deg), and the maxdist that takes its distance
#: radius to k = 3.
NEAREST_LON = np.linspace(0.0, 360.0, 64, endpoint=False).astype(np.float32)
NEAREST_MAXDIST = 2000.0


def test_distributed_runner_nearest_lon_form(tmp_path):
    """``DistributedRunner`` with ``distance_lon_form='nearest'`` (each
    shard's ``half_dlam`` from the global grid and k, inherited from
    ``ShardedPipeline``) on a 2 x 2 global mesh: bit-equal to one
    process's ``ShardedPipeline`` on the same mesh (checked in the ranks),
    and the ranks' blocks together against JAX ``TriggerPipeline(
    distance_lon_form='nearest').run``."""
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.params import Params
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    _spawn("nearest", tmp_path)
    blocks = [np.load(tmp_path / f"nearest.{r}.npz") for r in range(2)]
    got = {k: np.concatenate([b[k] for b in blocks], axis=-2)
           for k in blocks[0].files if k != "tt"}
    _, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    ref_state, ref = TriggerPipeline(
        Grid(lon=NEAREST_LON, lat=lat), Params(maxdist=NEAREST_MAXDIST),
        distance_lon_form="nearest").run(
        TriggerState.zeros(lsm.shape), theta, u, v, lsm, z, std, p, ci_t=ci)
    _outputs_close({k: got[k] for k in ref}, ref, "nearest runner vs JAX")
    np.testing.assert_allclose(got["final_thc"], np.asarray(ref_state.thc),
                               rtol=1e-6, atol=1e-5)


def test_diag_two_ranks_returns_global_fields(tmp_path):
    """``diag`` in two ranks: both return the same global fields, bit-equal
    to one process's ``diag(mesh=(2, 1))`` (checked in the ranks), and
    within the decomposed run's tolerance of ``diag()``."""
    _spawn("diag", tmp_path)
    a, b = (np.load(tmp_path / f"diag.{r}.npz") for r in range(2))
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_run(conf):
    from seabreeze_param_tpu.cli.run import main as jax_main
    from tests.test_torch_io import _jax_native_off
    with _jax_native_off():
        return jax_main(str(conf), progress=None)


def _files_close(written_ref, ref_root, root):
    from seabreeze_param_tpu_torch.io import Dataset
    for f_ref in written_ref:
        f = f_ref.replace(str(ref_root), str(root))
        assert os.path.isfile(f), f
        with Dataset(f_ref) as a, Dataset(f) as b:
            _outputs_close({v: np.ma.getdata(b.variables[v][:])
                            for v in ("sb_con", "thc")},
                           {v: np.ma.getdata(a.variables[v][:])
                            for v in ("sb_con", "thc")}, f)


def test_cli_driver_two_ranks_matches_jax(tmp_path_factory):
    """The batch driver in two ranks over the JAX package's synthetic
    series (160 x 288, two files of two steps): rank 0's files against the
    JAX single-process driver's, and rank 1 writes nothing."""
    from tests.test_io import _build_synthetic_run
    ref = _build_synthetic_run(tmp_path_factory.mktemp("tmh_ref"),
                               nlat=160, nlon=288, nt=2)
    mh = _build_synthetic_run(tmp_path_factory.mktemp("tmh"), nlat=160,
                              nlon=288, nt=2)
    written_ref = _jax_run(ref["conf"])[-1]
    assert len(written_ref) == 2
    _spawn("cli", mh["conf"], "-", 2)
    _files_close(written_ref, ref["root"], mh["root"])


def test_cli_driver_two_ranks_checkpoint_resume(tmp_path_factory, tmp_path):
    """Two ranks with ``ckpt_dir`` run the series; a relaunch of both on
    the same directory resumes with every file done: nothing is rewritten
    and the state is the checkpoint's, tt = 5 (two files of two steps from
    tt = 1)."""
    from tests.test_io import _build_synthetic_run
    mh = _build_synthetic_run(tmp_path_factory.mktemp("tmh_ck"), nlat=160,
                              nlon=288, nt=2)
    ck = tmp_path / "ck"
    outs = _spawn("cli", mh["conf"], ck, 2)
    assert all("tt=5" in out for out in outs)
    outs = _spawn("cli", mh["conf"], ck, 0)
    assert all("tt=5" in out for out in outs)


# -- the ranks' side -----------------------------------------------------------
def _rank_units():
    import torch
    from seabreeze_param_tpu_torch.core import checkpoint
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.ops.orography import sigmoid_weight_shards
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.halo import (halo_exchange_plain,
                                                         halo_pad)
    from seabreeze_param_tpu_torch.parallel.mesh import ShardMesh, split
    import tempfile

    r = dist.rank()
    mesh = dist.make_multihost_mesh((4, 2), device="cpu")
    assert (mesh.shape, mesh.global_shape, mesh.row0) == ((2, 2), (4, 2),
                                                          2 * r)
    one = ShardMesh(4, 2, torch.device("cpu"))
    rng = np.random.default_rng(5)
    field = torch.as_tensor(rng.random((2, 24, 20), np.float32))
    everyone = split(field, one)
    mine = everyone[4 * r:4 * r + 4]
    for hy, hx in ((1, 1), (3, 2), (6, 5), (0, 3), (4, 0)):
        for fill, exact in (("clamp", True), ("clamp", False),
                            ("zero", False)):
            ref = halo_exchange_plain(everyone, one, hy, hx, lat_fill=fill,
                                      exact_lon=exact)[4 * r:4 * r + 4]
            for backend in ("kernel", "plain"):
                got = halo_pad(mine, mesh, hy, hx, lat_fill=fill,
                               exact_lon=exact, backend=backend)
                for g, want in zip(got, ref):
                    assert torch.equal(g, want), (hy, hx, fill, exact,
                                                  backend)
    print(f"halo ok {r}", flush=True)

    std = torch.as_tensor(120 * rng.random((22, 20), np.float32))
    padded = std[torch.arange(24).clamp(max=21)]
    valid = [(torch.arange(6 * iy, 6 * iy + 6) < 22)[:, None]
             for iy in range(4) for _ in range(2)]
    ref = sigmoid_weight_shards(split(padded, one), valid)[4 * r:4 * r + 4]
    got = sigmoid_weight_shards(split(padded[12 * r:12 * r + 12], mesh),
                                valid[4 * r:4 * r + 4], dist.all_gather_cat)
    assert all(torch.equal(g, w) for g, w in zip(got, ref))
    print(f"sigmoid ok {r}", flush=True)

    state = TriggerState(7, *(rng.random((3, 22, 20), np.float32)))
    lo, hi = 11 * r, 11 * r + 11
    d = tempfile.mkdtemp() if r == 0 else None
    d = [d]
    torch.distributed.broadcast_object_list(d, 0)
    assert checkpoint.restore_state_sharded(d[0], lo, hi) is None
    block = TriggerState(7, *(getattr(state, f)[lo:hi]
                              for f in ("thc", "windspeed", "winddir")))
    assert checkpoint.save_state_sharded(d[0], block, lo) == 7
    back = checkpoint.restore_state_sharded(d[0], lo, hi)
    whole = checkpoint.restore_state_sharded(d[0], 0, 22)
    for f in ("thc", "windspeed", "winddir"):
        np.testing.assert_array_equal(getattr(back, f),
                                      getattr(state, f)[lo:hi])
        np.testing.assert_array_equal(getattr(whole, f), getattr(state, f))
    assert back.tt == whole.tt == 7
    print(f"sharded checkpoint ok {r}", flush=True)

    for shape in ((3, 2), "1x4"):
        try:
            dist.make_multihost_mesh(shape, device="cpu")
        except ValueError as e:
            assert "cannot split y=" in str(e) and "over 2 processes" in str(e)
        else:
            raise AssertionError(f"mesh {shape} accepted")
    assert dist.make_multihost_mesh(device="cpu").global_shape == (2, 1)
    print(f"mesh ok {r}", flush=True)


def _rank_runner(out_dir):
    import torch
    from seabreeze_param_tpu_torch.core.grid import Grid
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    lon, lat, fields = world()
    # the 4 x 2 mesh of the JAX package's test, overlapped and basic; then
    # 63 rows on 2 x 2, whose last rank pads a row
    for rows, shape, overlap in ((64, (4, 2), True), (64, (4, 2), False),
                                 (63, (2, 2), "auto")):
        lsm, z, std, p, theta, u, v, ci = (a if a.ndim == 1 else
                                           a[..., :rows, :] for a in fields)
        pipe = TriggerPipeline(Grid(lon=lon, lat=lat[:rows]), device="cpu")
        mesh = dist.make_multihost_mesh(shape, device="cpu")
        zeros = TriggerState.zeros(lsm.shape, "cpu")
        sp = ShardedPipeline(pipe, mesh, overlap=overlap)
        runner = dist.DistributedRunner(sp)
        lo, hi = runner.row_lo, min(runner.row_hi, sp.nlat_real)

        def slab(a):
            return np.asarray(a)[..., lo:hi, :]

        final, outs = runner.run(
            TriggerState(zeros.tt, *(slab(getattr(zeros, f)) for f in
                                     ("thc", "windspeed", "winddir"))),
            slab(theta), slab(u), slab(v), slab(lsm), slab(z), slab(std), p,
            ci_t=slab(ci))
        one = ShardedPipeline(pipe, make_mesh(shape, "cpu"), overlap=overlap)
        assert one.overlapped() == sp.overlapped()
        rstate, ref = one.run(zeros, theta, u, v, lsm, z, std, p, ci_t=ci)
        for key in ref:
            assert torch.equal(outs[key], ref[key][:, lo:hi]), key
        for f in ("thc", "windspeed", "winddir"):
            assert torch.equal(getattr(final, f),
                               getattr(rstate, f)[lo:hi]), f
        assert final.tt == rstate.tt
        # the same mesh from global arrays, gathered on every rank
        gstate, gout = sp.run(zeros, theta, u, v, lsm, z, std, p, ci_t=ci)
        assert all(torch.equal(gout[k], ref[k]) for k in ref)
        assert torch.equal(gstate.windspeed, rstate.windspeed)
        if rows == 64 and overlap:
            np.savez(os.path.join(out_dir, f"runner.{dist.rank()}.npz"),
                     final_thc=final.thc.numpy(), tt=np.array([final.tt]),
                     **{k: o.numpy() for k, o in outs.items()})


def _rank_nearest(out_dir):
    import torch
    from seabreeze_param_tpu_torch.core.grid import Grid
    from seabreeze_param_tpu_torch.core.params import Params
    from seabreeze_param_tpu_torch.core.state import TriggerState
    from seabreeze_param_tpu_torch.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    from seabreeze_param_tpu_torch.parallel.mesh import make_mesh
    from seabreeze_param_tpu_torch.parallel.sharded import ShardedPipeline

    _, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    pipe = TriggerPipeline(Grid(lon=NEAREST_LON, lat=lat),
                           Params(maxdist=NEAREST_MAXDIST), device="cpu",
                           distance_lon_form="nearest")
    assert pipe.k == 3
    zeros = TriggerState.zeros(lsm.shape, "cpu")
    sp = ShardedPipeline(pipe, dist.make_multihost_mesh((2, 2),
                                                        device="cpu"))
    assert sp.half_dlam is not None
    runner = dist.DistributedRunner(sp)
    lo, hi = runner.row_lo, runner.row_hi

    def slab(a):
        return np.asarray(a)[..., lo:hi, :]

    final, outs = runner.run(
        TriggerState(zeros.tt, *(slab(getattr(zeros, f)) for f in
                                 ("thc", "windspeed", "winddir"))),
        slab(theta), slab(u), slab(v), slab(lsm), slab(z), slab(std), p,
        ci_t=slab(ci))
    one = ShardedPipeline(pipe, make_mesh((2, 2), "cpu"))
    rstate, ref = one.run(zeros, theta, u, v, lsm, z, std, p, ci_t=ci)
    for key in ref:
        assert torch.equal(outs[key], ref[key][:, lo:hi]), key
    for f in ("thc", "windspeed", "winddir"):
        assert torch.equal(getattr(final, f), getattr(rstate, f)[lo:hi]), f
    np.savez(os.path.join(out_dir, f"nearest.{dist.rank()}.npz"),
             final_thc=final.thc.numpy(), tt=np.array([final.tt]),
             **{k: o.numpy() for k, o in outs.items()})


def _rank_diag(out_dir):
    from seabreeze_param_tpu_torch.api import diag
    from seabreeze_param_tpu_torch.parallel import distributed as dist

    lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
    args = (1, lsm, z, std, lon, lat, p, u, v, theta, ci)
    got = diag(*args, device="cpu", full_output=True)
    assert got[0] == 3 and got[1].shape == (2, 64, 64)
    np.savez(os.path.join(out_dir, f"diag.{dist.rank()}.npz"),
             sb=got[1], thc=got[2], ws=got[3], wd=got[4],
             **{k: o for k, o in got[5].items()})
    return got


def _rank_cli(conf, ckpt_dir, expect_written):
    from seabreeze_param_tpu_torch.cli.run import main
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    kw = {} if ckpt_dir == "-" else {"ckpt_dir": ckpt_dir}
    tt, thc, ws, wd, written = main(conf, progress=None, device="cpu", **kw)
    assert dist.world_size() == 2
    want = int(expect_written) if dist.rank() == 0 else 0
    assert len(written) == want, written
    assert thc.shape == ws.shape == wd.shape == (160, 288)
    print(f"tt={tt}", flush=True)


def _rank_main(case, *args):
    import torch
    torch.set_num_threads(2)
    if case == "diag":
        # one process's diag on the same global mesh, and undecomposed,
        # before the group exists
        from seabreeze_param_tpu_torch.api import diag
        lon, lat, (lsm, z, std, p, theta, u, v, ci) = world()
        ref_args = (1, lsm, z, std, lon, lat, p, u, v, theta, ci)
        ref = diag(*ref_args, device="cpu", full_output=True, mesh=(2, 1))
        undecomposed = diag(*ref_args, device="cpu", full_output=True)
    from seabreeze_param_tpu_torch.parallel import distributed as dist
    dist.initialize()
    assert dist.world_size() == 2
    if case == "units":
        _rank_units()
    elif case == "runner":
        _rank_runner(*args)
    elif case == "nearest":
        _rank_nearest(*args)
    elif case == "diag":
        got = _rank_diag(*args)
        for i in range(1, 5):
            np.testing.assert_array_equal(got[i], ref[i])
        for key in ref[5]:
            np.testing.assert_array_equal(got[5][key], ref[5][key])
        _outputs_close(got[5], undecomposed[5], "diag vs undecomposed")
    elif case == "cli":
        _rank_cli(*args)
    dist.barrier()
    print(f"TORCH-MULTIHOST-OK {case} {dist.rank()}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
