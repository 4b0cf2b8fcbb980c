"""The plain versions of the port's kernels against the JAX package on the
CPU, and the kernel wrappers' CPU dispatch.  The CUDA kernels themselves
are held against these plain versions in ``tests/test_torch_cuda.py``, on
a machine with an NVIDIA GPU.

B2 — ``ops.distance.pass2_min`` vs JAX ``pass2_min_pallas`` (interpret
mode) and JAX ``pass2_min``.  B1 — ``ops.trigger.trigger_core`` (with
``ring_thc_from_padded``) vs JAX ``trigger_core_stacked`` through
``ring_trigger_pallas_stacked`` (interpret mode) and vs the JAX XLA
``trigger_core``.  B3 — ``ops.distance.min_haversine_param_from_padded`` vs
``min_haversine_param_pallas``.  B4 — ``ring_trigger_cuda_padded``'s plain
version vs ``ring_trigger_pallas_padded``.  B5 — ``ring_thc_cuda_padded``'s
plain version vs ``ring_thc_pallas_padded`` (all interpret mode).
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
from seabreeze_param_tpu.ops import ring_search as jring
from seabreeze_param_tpu.ops.pallas.distance_kernel import (
    min_haversine_param_pallas, pass2_min_pallas)
from seabreeze_param_tpu.ops.pallas.ring_kernel import (
    CompactStackedScan, ring_thc_pallas_padded, ring_trigger_pallas_padded)
from seabreeze_param_tpu_torch.core.params import Params as TParams
from seabreeze_param_tpu_torch.core.state import state_from_numpy
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops import indexing as tidx
from seabreeze_param_tpu_torch.ops import ring_search as tring
from seabreeze_param_tpu_torch.ops import trigger as ttrig
from seabreeze_param_tpu_torch.ops.cuda import _build
from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
    min_haversine_param_cuda, pass2_min_cuda)
from seabreeze_param_tpu_torch.ops.cuda.ring_kernel import (
    TILE, StackedScan, coastal_tile_pred, ring_thc_cuda_padded,
    ring_trigger_cuda_padded, ring_trigger_cuda_stacked, tile_grid)

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


#: B1's tile geometry: under one tile, exactly one tile, one tile and one
#: cell, ragged in both axes, several whole tiles, and the 0.25-degree field.
TILE_SHAPES = [(10, 20), (16, 32), (17, 33), (37, 70), (48, 96), (721, 1440)]


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("maxdist", [0.0, 180.0, 1.0e9])
def test_coastal_tile_mask_geometry(shape, maxdist):
    """tile_grid and the ever-coastal mask B1 ranks, at its tile: the mask
    against a loop over the tiles (np.flatnonzero of the tiles holding a
    cell with |cd| <= maxdist), the band on a tile's last row and column
    counted, and StackedScan.add_coastal over three steps the running OR of
    the steps' masks (monotone: a tile once set stays set)."""
    th, tw = TILE
    ni, nj = tile_grid(*shape)
    assert (ni, nj) == (-(-shape[0] // th), -(-shape[1] // tw))
    rng = np.random.default_rng(shape[0] * shape[1])
    scan = StackedScan(*shape, TParams(maxdist=maxdist), "cpu")
    want_ever = np.zeros(ni * nj, np.uint8)
    for step in range(3):
        cd = (400 * rng.standard_normal(shape)).astype(np.float32)
        cd[np.abs(cd) < 300] = 12000.0
        cd[-1, -1] = 0.0 if step == 1 else cd[-1, -1]   # the last cell's tile
        pred = coastal_tile_pred(torch.as_tensor(cd), maxdist).numpy()
        want = np.zeros(ni * nj, np.uint8)
        for t in range(ni * nj):
            i, j = divmod(t, nj)
            want[t] = np.any(np.abs(cd[i * th:(i + 1) * th,
                                       j * tw:(j + 1) * tw]) <= maxdist)
        np.testing.assert_array_equal(np.flatnonzero(pred),
                                      np.flatnonzero(want))
        want_ever |= want
        ever = scan.add_coastal(torch.as_tensor(cd))
        np.testing.assert_array_equal(ever.numpy(), want_ever)
    assert ever.dtype == torch.uint8 and ever.shape == (ni * nj,)


def test_build_key_tracks_sources():
    """The library name hashes the sources; the build goes under
    build/kernels/ beside the package (git-ignored)."""
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.parent.name == "kernels"
    assert {s.name for s in _build.SRC_DIR.glob("*.cu")} == {
        "halo_exchange.cu", "min_haversine.cu", "pass2_min.cu",
        "ring_trigger.cu"}
    assert {"sbz_min_haversine", "sbz_ring_trigger_padded",
            "sbz_ring_thc_padded", "sbz_halo_exchange"} <= set(
                _build.SIGNATURES)


def _distance_inputs(c):
    grid = Grid(lon=c["lon"], lat=c["lat"])
    k = jdist.effective_radius(grid, 180.0)
    coast = np.asarray(jco.get_edges(c["lsm"], c["ci_t"][0]))
    return coast, jdist.distance_tables(grid, k), k


@pytest.mark.parametrize("case", CASES)
def test_min_haversine_plain_matches_jax(case, request):
    """B3's plain version (both passes on the padded coast) against the
    fused Pallas kernel (interpret mode) and the JAX two-pass form: BIG
    structure equal, then rtol 3e-7 (one ULP: XLA may contract the
    multiply-add, tests/test_pallas_kernels.py:36-39)."""
    coast, tables, k = _distance_inputs(request.getfixturevalue(case))
    cpad = tdist.pad_coast(T(coast), k)
    got = _np(tdist.min_haversine_param_from_padded(
        cpad, *(T(t) for t in tables), k))
    for ref in (min_haversine_param_pallas(coast, *tables, k, interpret=True),
                jdist.min_haversine_param(coast, *tables, k)):
        ref = _np(ref)
        np.testing.assert_array_equal(got > BIG / 2, ref > BIG / 2)
        sel = ref < BIG / 2
        np.testing.assert_allclose(got[sel], ref[sel], rtol=3e-7, atol=0)


def _padded_step(c, tt):
    """One step's inputs, t0 and the wind from the JAX package, handed to
    both as numpy: (nn, cdist, st, t0, ws_new, wd_new, jpad)."""
    grid, nn, cdist, st, theta, u, v = _trigger_inputs(c, tt)
    params = Params()
    t0 = np.asarray(jtrig.sea_level_temperature(
        theta, c["z"], jtrig.sigmoid_weight(c["std"])))
    ws_new, wd_new = (np.asarray(a) for a in jtrig.wind_at_level(
        u, v, c["p"], params.target_plev_pa))
    jpad = [np.asarray(jidx.pad2d(jnp.asarray(a), nn, nn))
            for a in (t0, cdist)]
    return nn, cdist, st, t0, ws_new, wd_new, jpad


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_ring_trigger_padded_plain_matches_jax(case, tt, request):
    """B4's wrapper on CPU tensors (its plain version) against
    ``ring_trigger_pallas_padded`` (interpret mode): sb within 2e-5/2e-4
    with MISSING structure equal, the new wind state bit-equal
    (tests/test_pallas_kernels.py:178-183), across seeding (1), a plain
    step (5) and a refresh (15).  No launch is counted."""
    c = request.getfixturevalue(case)
    nn, cdist, st, t0, ws_new, wd_new, jpad = _padded_step(c, tt)
    is_first, upd = ttrig.cadence(tt, TParams())
    before = ring_trigger_cuda_padded.launches
    ws_s, wd_s = T(st["ws"]), T(st["wd"])
    sb, ws_o, wd_o = ring_trigger_cuda_padded(
        *(T(a) for a in jpad), T(cdist), T(ws_new), T(wd_new), ws_s, wd_s,
        is_first, upd, TParams(), nn)
    assert ring_trigger_cuda_padded.launches == before
    np.testing.assert_array_equal(_np(ws_s), st["ws"])   # inputs untouched
    rsb, rws, rwd = ring_trigger_pallas_padded(
        *jpad, cdist, ws_new, wd_new, st["ws"], st["wd"], jnp.bool_(is_first),
        jnp.bool_(upd), Params(), nn, interpret=True)
    _close(sb, rsb, "sb")
    np.testing.assert_array_equal(_np(ws_o), _np(rws))
    np.testing.assert_array_equal(_np(wd_o), _np(rwd))
    # the state is frozen in the last row, whose sb is zero
    np.testing.assert_array_equal(_np(ws_o)[-1], st["ws"][-1])
    np.testing.assert_array_equal(_np(sb)[-1], 0.0)


@pytest.mark.parametrize("case", CASES)
def test_ring_thc_plain_matches_jax(case, request):
    """B5's wrapper on CPU tensors (its plain version) against
    ``ring_thc_pallas_padded`` (interpret mode) and the JAX ``ring_thc``:
    atol 2e-4, exactly zero off the coastal band
    (tests/test_pallas_kernels.py:116-119); the port's ``ring_thc`` gives
    the same field."""
    c = request.getfixturevalue(case)
    nn, cdist, _, _, _, _, _ = _padded_step(c, 1)
    rng = np.random.default_rng(4)
    t0 = (290.0 + 8.0 * rng.standard_normal(cdist.shape)).astype(np.float32)
    tpad = [tidx.pad2d(T(a), nn, nn) for a in (t0, cdist)]
    before = ring_thc_cuda_padded.launches
    got = ring_thc_cuda_padded(*tpad, T(cdist), nn, maxdist=180.0)
    assert ring_thc_cuda_padded.launches == before
    pal = ring_thc_pallas_padded(
        *(jidx.pad2d(jnp.asarray(a), nn, nn) for a in (t0, cdist)), cdist, nn,
        maxdist=180.0, interpret=True)
    ref, _ = jring.ring_thc(jnp.asarray(t0), cdist, nn, maxdist=180.0)
    for r in (pal, ref):
        np.testing.assert_allclose(_np(got), _np(r), rtol=0, atol=2e-4)
    off = np.abs(cdist) > 180.0
    assert (_np(got)[off] == 0.0).all() and (_np(pal)[off] == 0.0).all()
    n_thc, found = tring.ring_thc(T(t0), T(cdist), nn, maxdist=180.0)
    torch.testing.assert_close(n_thc, got, rtol=0, atol=0)
    np.testing.assert_array_equal(_np(found), _np(jring.ring_thc(
        jnp.asarray(t0), cdist, nn, maxdist=180.0)[1]))


def test_new_wrappers_on_cpu_are_the_plain_versions(small_case):
    """B3's and B4's wrappers on CPU tensors return their plain versions
    exactly and count no launch; B4's equals ``trigger_cells``' sb and new
    state."""
    coast, tables, k = _distance_inputs(small_case)
    args = (tdist.pad_coast(T(coast), k), *(T(t) for t in tables), k)
    before = min_haversine_param_cuda.launches
    torch.testing.assert_close(min_haversine_param_cuda(*args),
                               tdist.min_haversine_param_from_padded(*args),
                               rtol=0, atol=0)
    assert min_haversine_param_cuda.launches == before

    nn, cdist, st, t0, ws_new, wd_new, jpad = _padded_step(small_case, 15)
    targs = (*(T(a) for a in jpad), T(cdist), T(ws_new), T(wd_new),
             T(st["ws"]), T(st["wd"]), False, True, TParams(), nn)
    sb, ws_o, wd_o = ring_trigger_cuda_padded(*targs)
    ref = ttrig.trigger_cells(targs[2], *targs[3:7], *targs[:2],
                              *targs[7:])
    for got, want in zip((sb, ws_o, wd_o), (ref[0], ref[3], ref[4])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

