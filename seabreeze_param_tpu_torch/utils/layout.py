"""Array-layout interop helpers; a NumPy copy of
``seabreeze_param_tpu.utils.layout`` (the port imports no JAX package).

The reference funnels every array through a C-order <-> Fortran-order
converter ``c2f`` before and after each f2py kernel call
(``python_wrapper/seabreezediag/__init__.py:13-40``, applied at
``:229-239``): it reverses the axis order and re-views the buffer
column-major, so a NumPy (time, lev, lat, lon) C array becomes the
(lon, lat, lev, time) Fortran array the kernels expect.

The TPU framework needs none of this on its hot path — fields stay
(…, nlat, nlon) C-order end to end — but the converter is kept for interop
tests against Fortran-convention golden data and for users porting drivers
that pre-transposed their arrays.
"""
from __future__ import annotations

import numpy as np


def c2f(array: np.ndarray) -> np.ndarray:
    """Reverse axis order, preserving the linear memory sequence.

    Equivalent to the reference ``c2f`` (``__init__.py:13-40``):
    element ``a[i0, …, ik]`` of the input is element ``out[ik, …, i0]`` of
    the output, i.e. ``out = a.T`` materialized.  Involutory: c2f(c2f(a))
    round-trips exactly.
    """
    a = np.asarray(array)
    return a.ravel(order="C").reshape(a.shape[::-1], order="F")


def f2c(array: np.ndarray) -> np.ndarray:
    """Inverse of :func:`c2f` (the operation is its own inverse)."""
    return c2f(array)
