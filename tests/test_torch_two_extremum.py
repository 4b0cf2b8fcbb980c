"""The two-extremum form of the distance transform's passes against the
JAX package's, on the CPU.

Where po may be negative, a window's minimum of sdphi2 + po * sdlam2 may
sit at its largest sdlam2, so pass 1 also keeps the maxima
(``pass1_extrema(need_max=True)``) and pass 2 takes min(po * Mmin, po *
Mmax) a tap (``pass2_min(Mmax=)``, the plain version of the two-extremum
form of kernel B2, ``pass2_min_two_cuda``; the JAX package's
``pass2_min_pallas`` with ``Mmax``).  Inputs come from a seed with numpy:
the conftest's worlds' coastlines and their tables, and random tables with
po in [-1, 1].  Tolerances (``tests/test_pallas_kernels.py:59-80``): the
BIG structure equal, then rtol 3e-7 against the Pallas kernel (interpret
mode) and bit for bit against the JAX package's plain pass 2 (the min
between the multiply and the add leaves XLA no product to contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.ops import coastline as jco
from seabreeze_param_tpu.ops import distance as jdist
from seabreeze_param_tpu.ops.pallas.distance_kernel import pass2_min_pallas
from seabreeze_param_tpu_torch.ops import distance as tdist
from seabreeze_param_tpu_torch.ops.cuda.distance_kernel import (
    pass2_min_cuda, pass2_min_two_cuda)

BIG = np.float32(1.0e30)


def _extrema(c, k, step=0):
    """Pass 1 of both packages on a world's coastline at radius k: the
    JAX package's (Mmin, Mmax) as numpy, after checking the port's equal
    to them bit for bit, and the world's tables."""
    grid = JGrid(lon=c["lon"], lat=c["lat"])
    coast = np.array(jco.get_edges(c["lsm"], c["ci_t"][step]))
    tabs = jdist.distance_tables(grid, k)
    cpad = jdist.pad_coast(jnp.asarray(coast), k)
    ref = [np.asarray(m) for m in jdist.pass1_extrema(cpad, tabs[2], k,
                                                      need_max=True)]
    tpad = torch.as_tensor(np.array(cpad))
    got = tdist.pass1_extrema(tpad, torch.as_tensor(tabs[2]), k,
                              need_max=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    mmin, none = tdist.pass1_extrema(tpad, torch.as_tensor(tabs[2]), k)
    assert none is None
    np.testing.assert_array_equal(mmin.numpy(), ref[0])
    return ref, tabs


def _random_po(rng, h, k):
    return (2.0 * rng.random((h, 2 * k + 1)) - 1.0).astype(np.float32)


def _close_1ulp(got, ref):
    np.testing.assert_array_equal(got > BIG / 2, ref > BIG / 2)
    sel = ref < BIG / 2
    assert sel.any()
    np.testing.assert_allclose(got[sel], ref[sel], rtol=3e-7, atol=0)


@pytest.mark.parametrize("k", [0, 3, 15])
@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("po_kind", ["tables", "random"])
def test_pass2_two_extremum_matches_jax(case, k, po_kind, request):
    """The port's plain two-extremum pass 2 (and the kernel wrappers, which
    take it on CPU tensors) against JAX's Pallas kernel in interpret mode
    and JAX's plain pass 2, on a world's extrema with its own tables (po >=
    0) or with po in [-1, 1]."""
    c = request.getfixturevalue(case)
    (mmin, mmax), (sdphi2, po, _) = _extrema(c, k)
    if po_kind == "random":
        po = _random_po(np.random.default_rng(k + 100), sdphi2.shape[0], k)
    pallas = np.asarray(pass2_min_pallas(mmin, mmax, sdphi2, po, k,
                                         tile_rows=32, tile_cols=128,
                                         interpret=True))
    xla = np.asarray(jdist.pass2_min(mmin, mmax, sdphi2, po, k))
    T = torch.as_tensor
    args = (T(mmin), T(sdphi2), T(po), k)
    got = tdist.pass2_min(*args, Mmax=T(mmax)).numpy()
    _close_1ulp(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(
        pass2_min_two_cuda(T(mmin), T(mmax), *args[1:]).numpy(), got)
    np.testing.assert_array_equal(
        pass2_min_cuda(*args, Mmax=T(mmax)).numpy(), got)


@pytest.mark.parametrize("shape", [(5, 9), (29, 45), (37, 70)])
@pytest.mark.parametrize("k", [0, 3, 15])
def test_pass2_two_extremum_ragged_random(shape, k):
    """Ragged fields (no multiple of the Pallas kernel's tiles) of random
    extrema with empty windows, random sdphi2 with rows BIG at the lat
    edges, po in [-1, 1]: against JAX's Pallas kernel; and where po < 0
    the two forms differ, so the second channel is read."""
    h, w = shape
    rng = np.random.default_rng(h * 100 + w + k)
    mmin = rng.random((h + 2 * k, w)).astype(np.float32)
    mmax = np.maximum(mmin, rng.random(mmin.shape).astype(np.float32))
    empty = rng.random(mmin.shape) < 0.2
    mmin[empty], mmax[empty] = BIG, -BIG
    sdphi2 = rng.random((h, 2 * k + 1)).astype(np.float32)
    for y in range(min(h, k)):
        sdphi2[y, :k - y] = BIG
    po = _random_po(rng, h, k)
    pallas = np.asarray(pass2_min_pallas(mmin, mmax, sdphi2, po, k,
                                         tile_rows=16, tile_cols=128,
                                         interpret=True))
    T = torch.as_tensor
    got = tdist.pass2_min(T(mmin), T(sdphi2), T(po), k, Mmax=T(mmax))
    _close_1ulp(got.numpy(), pallas)
    single = tdist.pass2_min(T(mmin), T(sdphi2), T(po), k).numpy()
    assert (got.numpy() < single).any()
    assert (got.numpy() <= single).all()


def test_two_extremum_equals_single_where_po_nonnegative(global_case):
    """With the tables' own po (>= 0) the two forms give one minimum, as
    the JAX package's pass 2 test holds (its single form within one ULP)."""
    k = 3
    (mmin, mmax), (sdphi2, po, _) = _extrema(global_case, k, step=1)
    assert (po >= 0).all()
    T = torch.as_tensor
    two = tdist.pass2_min(T(mmin), T(sdphi2), T(po), k, Mmax=T(mmax))
    one = tdist.pass2_min(T(mmin), T(sdphi2), T(po), k)
    torch.testing.assert_close(two, one, rtol=0, atol=0)
