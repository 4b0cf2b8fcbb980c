"""Coastline extraction: land+ice mask and the binary Sobel edge filter.

Counterpart of ``seabreeze_param_tpu.ops.coastline`` (reference
``get_edges``, ``sobel.f90:19-89``).  A few shifted-slice adds over a
boundary-resolved padded field; plain torch ops (the TPU left this stage to
XLA fusion, so there is no kernel to port).

  * ``mask = lsm + ci`` binarized at ``> 0.4`` (sobel.f90:51, 69-73);
  * Sobel x/y gradients with the (1,2,1) smoothing taps (sobel.f90:54-75);
  * coast = 1 wherever the gradient is nonzero (sobel.f90:78-84);
  * lat clamped, lon through the quirky map (sobel.f90:67-68).
"""
from __future__ import annotations

import torch

from .indexing import pad2d


def make_mask(lsm, ci=None):
    """Combined land/sea-ice mask, binarized at 0.4, as float32."""
    m = lsm if ci is None else lsm + ci
    return (m > 0.4).to(torch.float32)


def sobel_edges_from_padded(p):
    """Sobel-edge core on a 1-padded binary block (h+2, w+2) -> (h, w)."""
    sm_lat = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]
    px = sm_lat[:, 2:] - sm_lat[:, :-2]
    sm_lon = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    py = sm_lon[2:, :] - sm_lon[:-2, :]
    return ((px != 0.0) | (py != 0.0)).to(torch.float32)


def sobel_edges(binary_mask, *, exact_lon: bool = True):
    """Binary coastline from a binary land mask."""
    return sobel_edges_from_padded(
        pad2d(binary_mask, 1, 1, exact_lon=exact_lon))


def get_edges(lsm, ci=None, *, exact_lon: bool = True):
    """Full ``get_edges`` equivalent: mask + Sobel in one call."""
    return sobel_edges(make_mask(lsm, ci), exact_lon=exact_lon)
