"""Boundary index maps of the reference, and halo padding built on them.

Counterpart of ``seabreeze_param_tpu.ops.indexing``.  The reference resolves
grid boundaries three ways (1-based Fortran indices):

* latitude rows are clamped: ``ki = min(max(1, i), nlats)``;
* longitudes, "quirky" map: ``kj = max(1, modulo(j, nlons))`` — the column
  left of column 1 clamps to column 1, and column nlons itself aliases to
  column 1 whenever reached through this map;
* longitudes, periodic map: ``xx = modulo(j, nlons); if (xx==0) xx=nlons``.

The maps are NumPy copies of the JAX package's (they are host-side index
arithmetic); :func:`pad2d` builds the padded tensor from slices and
``torch.cat``, index-for-index identical to gathering through
:func:`pad_indices`.
"""
from __future__ import annotations

import numpy as np
import torch


def lat_index_clamped(i, nlat: int):
    """0-based row map for the Fortran clamp min(max(1, i+1), nlat)."""
    return np.clip(i, 0, nlat - 1)


def lon_index_quirky(j, nlon: int):
    """0-based column map for Fortran ``max(1, modulo(j+1, nlons))``."""
    j = np.asarray(j)
    return np.maximum(1, (j + 1) % nlon) - 1


def lon_index_periodic(j, nlon: int):
    """0-based column map for true periodic wraparound."""
    j = np.asarray(j)
    return j % nlon


def pad_indices(n: int, pad: int, index_map) -> np.ndarray:
    """Indices selecting a (n + 2*pad)-wide padded axis from an n-wide axis,
    boundary-resolved through ``index_map``."""
    return np.asarray(index_map(np.arange(-pad, n + pad), n), np.int64)


def _take(field, dim: int, idx: np.ndarray):
    """Gather for degenerate pads (pad wider than the axis)."""
    return field.index_select(dim, torch.as_tensor(idx, device=field.device))


def pad2d(field, pad_lat: int, pad_lon: int, *, exact_lon: bool = True):
    """Pad a (..., nlat, nlon) tensor through the boundary index maps.

    Rows use the clamped map; columns the quirky map when ``exact_lon``
    (reference parity), else the periodic map:

      * clamped rows: [row0] * p ++ rows ++ [row n-1] * p
      * quirky cols:  cols[n-p : n-1] ++ [col0]      (left pad)
                      ++ cols[0 : n-1] ++ [col0]     (centre: col n-1
                        aliases col 0 — Fortran modulo(nlons, nlons) = 0)
                      ++ cols[0 : p]                 (right pad)
      * periodic:     cols[n-p :] ++ cols ++ cols[: p]
    """
    nlat, nlon = field.shape[-2], field.shape[-1]
    out = field
    if pad_lat:
        if pad_lat > nlat:
            out = _take(out, -2, pad_indices(nlat, pad_lat,
                                             lat_index_clamped))
        else:
            rep = list(out.shape)
            rep[-2] = pad_lat
            top = out[..., :1, :].expand(rep)
            bot = out[..., -1:, :].expand(rep)
            out = torch.cat([top, out, bot], dim=-2)
    if pad_lon:
        lon_map = lon_index_quirky if exact_lon else lon_index_periodic
        if pad_lon > nlon - 1:
            out = _take(out, -1, pad_indices(nlon, pad_lon, lon_map))
        elif exact_lon:
            first = out[..., :, :1]
            out = torch.cat([out[..., :, nlon - pad_lon:nlon - 1], first,
                             out[..., :, :nlon - 1], first,
                             out[..., :, :pad_lon]], dim=-1)
        else:
            out = torch.cat([out[..., :, nlon - pad_lon:], out,
                             out[..., :, :pad_lon]], dim=-1)
    return out


def remap_lon_quirky(field):
    """Re-index the unpadded columns of a (..., nlat, nlon) tensor through
    the quirky map: column nlon-1 aliases column 0 when addressed as a
    window centre (Fortran ``modulo(nlons, nlons) == 0``), which
    :func:`pad2d` already does for the padded copy; for code that indexes
    centres directly."""
    return torch.cat([field[..., :, :-1], field[..., :, :1]], dim=-1)
