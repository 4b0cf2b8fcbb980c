"""Wrapper of kernel B2 (``csrc/pass2_min.cu``): pass 2 of the separable
coast-distance minimum.  Replaces the JAX package's
``ops/pallas/distance_kernel.py::pass2_min_pallas``; its plain version is
``ops.distance.pass2_min``."""
from __future__ import annotations

import torch

from ..distance import pass2_min
from . import _build


def pass2_min_cuda(Mmin, sdphi2, po, k: int):
    """amin (h, w) = min over the lat window of sdphi2 + po * Mmin.

    ``Mmin`` (h+2k, w), ``sdphi2``/``po`` (h, 2k+1), float32, contiguous.
    A CUDA tensor launches the kernel on the current stream; a CPU tensor
    takes the plain version.  Each launch adds one to
    ``pass2_min_cuda.launches``.
    """
    k = int(k)
    if Mmin.device.type == "cpu":
        return pass2_min(Mmin, sdphi2, po, k)
    h, w = Mmin.shape[0] - 2 * k, Mmin.shape[1]
    _build.require(Mmin, "Mmin", (h + 2 * k, w), Mmin.device)
    _build.require(sdphi2, "sdphi2", (h, 2 * k + 1), Mmin.device)
    _build.require(po, "po", (h, 2 * k + 1), Mmin.device)
    out =torch.empty((h, w), dtype=torch.float32, device=Mmin.device)
    lib = _build.load()
    with torch.cuda.device(Mmin.device):
        err = lib.sbz_pass2_min(
            Mmin.data_ptr(), sdphi2.data_ptr(), po.data_ptr(),
            out.data_ptr(), h, w, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pass2_min_cuda")
    pass2_min_cuda.launches += 1
    return out


pass2_min_cuda.launches = 0
