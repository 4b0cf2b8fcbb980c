"""The plain versions of the port's two kernels against the JAX package on
the CPU, and the kernel wrappers' CPU dispatch.  The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_cuda.py``, on a machine with an NVIDIA GPU.

B2 — ``ops.distance.pass2_min`` vs JAX ``pass2_min_pallas`` (interpret
mode) and JAX ``pass2_min``.  B1 — ``ops.trigger.trigger_core`` (with
``ring_thc_from_padded``) vs JAX ``trigger_core_stacked`` through
``ring_trigger_pallas_stacked`` (interpret mode) and vs the JAX XLA
``trigger_core``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.core.params import Params
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline as JPipe
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu.ops import indexing as jidx
from seabreeze_param_tpu.ops import trigger as jtrig
from seabreeze_param_tpu.ops.pallas.distance_kernel import pass2_min_pallas
from seabreeze_param_tpu.ops.pallas.ring_kernel import CompactStackedScan
from seabreeze_param_tpu_torch.core.params import Params as TParams
from seabreeze_param_tpu_torch.core.state import state_from_numpy
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops import indexing as tidx
from seabreeze_param_tpu_torch.ops import trigger as ttrig
from seabreeze_param_tpu_torch.ops.cuda import _build
from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import pass2_min_cuda
from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
    TILE, StackedScan, coastal_tile_pred, ring_trigger_cuda_stacked)

CASES = ["small_case", "global_case"]
MISSING = np.float32(2.0e20)
BIG = np.float32(1.0e30)


def T(a):
    """A CPU tensor holding a copy of ``a``."""
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pass2_inputs(c):
    grid = Grid(lon=c["lon"], lat=c["lat"])
    k = jdist.effective_radius(grid, 180.0)
    sdphi2, po, sdlam2 = jdist.distance_tables(grid, k)
    coast = jco.get_edges(c["lsm"], c["ci_t"][0])
    Mmin, _ = jdist.pass1_extrema(jdist.pad_coast(coast, k), sdlam2, k)
    return np.array(Mmin), sdphi2, po, k


@pytest.mark.parametrize("case", CASES)
def test_pass2_plain_matches_jax(case, request):
    """BIG structure equal, then rtol 3e-7 (one ULP: XLA may contract the
    multiply-add, tests/test_pallas_kernels.py)."""
    Mmin, sdphi2, po, k = _pass2_inputs(request.getfixturevalue(case))
    got = _np(tdist.pass2_min(T(Mmin), T(sdphi2), T(po), k))
    for ref in (pass2_min_pallas(Mmin, None, sdphi2, po, k, interpret=True),
                jdist.pass2_min(Mmin, None, sdphi2, po, k)):
        ref = _np(ref)
        np.testing.assert_array_equal(got > BIG / 2, ref > BIG / 2)
        sel = ref < BIG / 2
        np.testing.assert_allclose(got[sel], ref[sel], rtol=3e-7, atol=0)


def _trigger_inputs(c, tt):
    """A world's coast distance (from the JAX package), the ring bound, a
    random carried state and one step's random theta, u and v."""
    grid = Grid(lon=c["lon"], lat=c["lat"])
    nn = JPipe(grid).nn_max
    coast = jco.get_edges(c["lsm"], c["ci_t"][0])
    cdist = np.asarray(jdist.coast_distance(coast, c["lsm"], grid, 180.0))
    rng = np.random.default_rng(7 + tt)
    shape = c["lsm"].shape
    st = dict(thc=(290 + rng.standard_normal(shape)).astype(np.float32),
              ws=(5 + rng.random(shape)).astype(np.float32),
              wd=(360 * rng.random(shape) - 180).astype(np.float32))
    nlev = len(c["p"])
    theta = (288 + 5 * rng.standard_normal(shape)).astype(np.float32)
    u = (6 * rng.standard_normal((nlev,) + shape)).astype(np.float32)
    v = (6 * rng.standard_normal((nlev,) + shape)).astype(np.float32)
    return grid, nn, cdist, st, theta, u, v


def _jstate(tt, st):
    return JState(tt=jnp.int32(tt), thc=jnp.asarray(st["thc"]),
                  windspeed=jnp.asarray(st["ws"]),
                  winddir=jnp.asarray(st["wd"]))


def _close(got, ref, what):
    """MISSING structure equal, then rtol 2e-5 / atol 2e-4."""
    got, ref = _np(got), _np(ref)
    miss = ref == MISSING
    np.testing.assert_array_equal(got == MISSING, miss, err_msg=what)
    np.testing.assert_allclose(got[~miss], ref[~miss], rtol=2e-5, atol=2e-4,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_trigger_core_plain_matches_jax(case, tt, request):
    """The plain B1 path against the Pallas stacked kernel (interpret) and
    the XLA trigger_core, at first-step seeding (1), a plain step (5) and a
    wind refresh (15): per-step fields within 2e-5/2e-4 with MISSING
    structure equal, the wind state bit-equal, the last-row quirk kept."""
    c = request.getfixturevalue(case)
    grid, nn, cdist, st, theta, u, v = _trigger_inputs(c, tt)
    params = Params()
    h, w = cdist.shape
    # t0 and the wind from the JAX package, handed to both as numpy
    t0 = np.asarray(jtrig.sea_level_temperature(
        theta, c["z"], jtrig.sigmoid_weight(c["std"])))
    ws_new, wd_new = (np.asarray(a) for a in jtrig.wind_at_level(
        u, v, c["p"], params.target_plev_pa))
    jpad = [jidx.pad2d(jnp.asarray(a), nn, nn) for a in (t0, cdist)]

    # the port, plain path
    tstate = state_from_numpy(tt, st["thc"], st["ws"], st["wd"], "cpu")
    got_state, got = ttrig.trigger_core(
        tstate, T(t0), T(cdist), T(ws_new), T(wd_new),
        tidx.pad2d(T(t0), nn, nn), tidx.pad2d(T(cdist), nn, nn), TParams(),
        nn)

    # JAX: XLA trigger_core, and the Pallas stacked kernel
    ref_state, ref = jtrig.trigger_core(
        _jstate(tt, st), t0, cdist, ws_new, wd_new, *jpad, params, nn)
    css = CompactStackedScan(h, w, nn, params.maxdist,
                             params.skip_last_lat_row)
    sb_b, ws_b, wd_b = css.init_buffers(1, jnp.asarray(st["ws"]),
                                        jnp.asarray(st["wd"]))
    _, ids, n = css.launch(css.ever0(), jnp.asarray(cdist))
    pal_state, pal_t0, sb_b, ws_b, wd_b = jtrig.trigger_core_stacked(
        _jstate(tt, st), t0, cdist, ws_new, wd_new, *jpad, params, nn, 0,
        sb_b, ws_b, wd_b, ids, n, pallas_interpret=True)
    pal = {"sb_con": np.asarray(sb_b)[0, :h, :w], "t0": pal_t0,
           "windspeed": np.asarray(ws_b)[0, :h, :w],
           "winddir": np.asarray(wd_b)[0, :h, :w]}

    for rs, rout in ((ref_state, ref), (pal_state, pal)):
        for key in ("sb_con", "t0", "windspeed", "winddir"):
            _close(got[key], rout[key], key)
        assert got_state.tt == int(rs.tt)
        np.testing.assert_allclose(_np(got_state.thc), _np(rs.thc),
                                   rtol=1e-6)
        np.testing.assert_array_equal(_np(got_state.windspeed),
                                      _np(rs.windspeed))
        np.testing.assert_array_equal(_np(got_state.winddir),
                                      _np(rs.winddir))
    # the quirk: zero outputs and frozen state in the last row
    np.testing.assert_array_equal(_np(got["windspeed"])[-1], 0.0)
    np.testing.assert_array_equal(_np(got["sb_con"])[-1], 0.0)
    np.testing.assert_array_equal(_np(got_state.windspeed)[-1], st["ws"][-1])


def test_stacked_wrapper_on_cpu_is_the_plain_version(small_case):
    """On CPU tensors the B1 wrapper writes the plain fields into its slot
    and the new wind state in place; the B2 wrapper returns pass2_min.  No
    launch is counted."""
    grid, nn, cdist, st, theta, u, v = _trigger_inputs(small_case, 15)
    params = TParams()
    t0, ws_new, wd_new, t0_pad, cd_pad = ttrig.prepare_step(
        T(theta), T(u), T(v), T(cdist), T(small_case["z"]),
        T(small_case["std"]), T(small_case["p"]), params, nn)
    ws_s, wd_s = T(st["ws"]).clone(), T(st["wd"]).clone()
    scan = StackedScan(*cdist.shape, params, "cpu")
    bufs = scan.init_buffers(3, ws_s, wd_s)
    launches = ring_trigger_cuda_stacked.launches
    ring_trigger_cuda_stacked(t0_pad, cd_pad, T(cdist), ws_new, wd_new, ws_s,
                              wd_s, False, True, params, nn, 1, *bufs,
                              scan.add_coastal(T(cdist)))
    ref = ttrig.trigger_cells(T(cdist), ws_new, wd_new, T(st["ws"]),
                              T(st["wd"]), t0_pad, cd_pad, False, True,
                              params, nn)
    for got, want in zip((bufs[0][1], bufs[1][1], bufs[2][1], ws_s, wd_s),
                         ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # slots 0 and 2 keep the pre-fill
    assert (bufs[0][0][:-1] == MISSING).all() and (bufs[0][2][-1] == 0).all()
    assert ring_trigger_cuda_stacked.launches == launches

    Mmin, sdphi2, po, k = _pass2_inputs(small_case)
    args = (T(Mmin), T(sdphi2), T(po), k)
    before = pass2_min_cuda.launches
    torch.testing.assert_close(pass2_min_cuda(*args), tdist.pass2_min(*args),
                               rtol=0, atol=0)
    assert pass2_min_cuda.launches == before


@pytest.mark.parametrize("shape", [(64, 64), (37, 70), (121, 240)])
def test_coastal_tile_pred_and_prefill(shape):
    """The ever-coastal tile mask against a loop over the tiles, and the
    pre-fill of the stacks (MISSING sb, passthrough wind, zero last row)."""
    rng = np.random.default_rng(3)
    cd = (400 * rng.standard_normal(shape)).astype(np.float32)
    cd[np.abs(cd) < 300] = 12000.0
    pred = coastal_tile_pred(torch.as_tensor(cd), 180.0).numpy()
    th, tw = TILE
    ni, nj = -(-shape[0] // th), -(-shape[1] // tw)
    want = [np.any(np.abs(cd[i * th:(i + 1) * th, j * tw:(j + 1) * tw])
                   <= 180.0) for i in range(ni) for j in range(nj)]
    np.testing.assert_array_equal(pred, np.asarray(want, np.uint8))

    ws0 = torch.as_tensor(rng.random(shape).astype(np.float32))
    scan = StackedScan(*shape, TParams(), "cpu")
    sb, ws, wd = scan.init_buffers(2, ws0, -ws0)
    assert sb.shape == ws.shape == (2,) + shape and sb.is_contiguous()
    assert (sb[:, :-1] == MISSING).all() and (sb[:, -1] == 0).all()
    torch.testing.assert_close(ws[1, :-1], ws0[:-1], rtol=0, atol=0)
    assert (wd[:, -1] == 0).all()
    ever = scan.add_coastal(torch.as_tensor(cd))
    assert ever is scan.ever and ever.sum() == pred.sum()


def test_build_key_tracks_sources():
    """The library name hashes the sources; the build goes under
    build/kernels/ beside the package (git-ignored)."""
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.parent.name == "kernels"
    assert {s.name for s in _build.SRC_DIR.glob("*.cu")} == {
        "pass2_min.cu", "ring_trigger.cu"}

