"""Wrappers of the distance-transform kernels, replacing the JAX package's
``ops/pallas/distance_kernel.py``:

* B2 :func:`pass2_min_cuda` (``csrc/pass2_min.cu``, replaces
  ``pass2_min_pallas``): pass 2 of the separable minimum; plain version
  ``ops.distance.pass2_min``; every radius (an unstaged build past
  :func:`pass2_min_limits`);
* B3 :func:`min_haversine_param_cuda` (``csrc/min_haversine.cu``, replaces
  ``min_haversine_param_pallas``): both passes fused, each block sweeping
  a band of columns; plain version
  ``ops.distance.min_haversine_param_from_padded``; every radius (the
  large build, its ring in device scratch, past
  :func:`min_haversine_limits`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..distance import min_haversine_param_from_padded, pass2_min
from . import _build


def pass2_min_cuda(Mmin, sdphi2, po, k: int):
    """amin (h, w) = min over the lat window of sdphi2 + po * Mmin.

    ``Mmin`` (h+2k, w), ``sdphi2``/``po`` (h, 2k+1), float32, contiguous.
    A CUDA tensor launches the kernel on the current stream (its staged
    build up to :func:`pass2_min_limits`, the unstaged one past it); a CPU
    tensor takes the plain version.  Each launch adds one to
    ``pass2_min_cuda.launches``.
    """
    k = int(k)
    if Mmin.device.type == "cpu":
        return pass2_min(Mmin, sdphi2, po, k)
    h, w = Mmin.shape[0] - 2 * k, Mmin.shape[1]
    _build.require(Mmin, "Mmin", (h + 2 * k, w), Mmin.device)
    _build.require(sdphi2, "sdphi2", (h, 2 * k + 1), Mmin.device)
    _build.require(po, "po", (h, 2 * k + 1), Mmin.device)
    out = torch.empty((h, w), dtype=torch.float32, device=Mmin.device)
    lib = _build.load()
    with torch.cuda.device(Mmin.device):
        err = lib.sbz_pass2_min(
            Mmin.data_ptr(), sdphi2.data_ptr(), po.data_ptr(),
            out.data_ptr(), h, w, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pass2_min_cuda")
    pass2_min_cuda.launches += 1
    return out


pass2_min_cuda.launches = 0


def _read_limit(name: str) -> int:
    value = ctypes.c_int()
    getattr(_build.load(), name)(ctypes.byref(value))
    return value.value


@functools.cache
def pass2_min_limits() -> int:
    """The widest radius k of kernel B2's staged build (MAX_STAGED_K in
    csrc/pass2_min.cu: its strip of (16+2k) x 128 floats grows with k);
    wider k runs the unstaged build.  Read from the built kernels, which
    it builds at the first call."""
    return _read_limit("sbz_pass2_min_limits")


@functools.cache
def min_haversine_limits() -> int:
    """The widest radius k of kernel B3's builds that stage in shared
    memory (MAX_K in csrc/min_haversine.cu: their shared memory grows
    linearly in k); wider k runs the large build, whose ring lives in
    device scratch.  Read from the built kernels, which it builds at the
    first call."""
    return _read_limit("sbz_min_haversine_limits")


def min_haversine_param_cuda(cpad, sdphi2, po, sdlam2, k: int, *,
                             monotone=None):
    """amin (h, w): the winning haversine parameter over the (2k+1)^2
    window, BIG where no coast cell is in reach.

    ``cpad`` (h+2k, w+2k) from ``ops.distance.pad_coast``; ``sdphi2``/``po``
    (h, 2k+1), ``sdlam2`` (w, 2k+1) from ``ops.distance.distance_tables``;
    float32, contiguous.  ``monotone``: the flags of
    ``ops.distance.DistanceTables`` (uint8, (w,)), or None, which takes no
    column to have the property (the kernel's loop over every coast bit of
    the window, the same result).  A CUDA tensor launches the kernel on the
    current stream (counted in ``min_haversine_param_cuda.launches``): k
    past :func:`min_haversine_limits` takes the large build, with device
    scratch allocated here.  A CPU tensor takes the plain version.
    """
    k = int(k)
    if cpad.device.type == "cpu":
        return min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k)
    dev = cpad.device
    h, w = cpad.shape[0] - 2 * k, cpad.shape[1] - 2 * k
    _build.require(cpad, "cpad", (h + 2 * k, w + 2 * k), dev)
    _build.require(sdphi2, "sdphi2", (h, 2 * k + 1), dev)
    _build.require(po, "po", (h, 2 * k + 1), dev)
    _build.require(sdlam2, "sdlam2", (w, 2 * k + 1), dev)
    if monotone is not None:
        _build.require(monotone, "monotone", (w,), dev, torch.uint8)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _build.load()
    args = (cpad.data_ptr(), sdphi2.data_ptr(), po.data_ptr(),
            sdlam2.data_ptr(),
            None if monotone is None else monotone.data_ptr(),
            out.data_ptr(), h, w, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if k <= min_haversine_limits():
            err = lib.sbz_min_haversine(*args, stream)
        else:
            floats = ctypes.c_longlong()
            err = lib.sbz_min_haversine_scratch(h, w, k,
                                                ctypes.byref(floats))
            if not err:
                scratch = torch.empty(floats.value, dtype=torch.float32,
                                      device=dev)
                err = lib.sbz_min_haversine_large(*args, scratch.data_ptr(),
                                                  stream)
    _build.check(err, "min_haversine_param_cuda")
    min_haversine_param_cuda.launches += 1
    return out


min_haversine_param_cuda.launches = 0
