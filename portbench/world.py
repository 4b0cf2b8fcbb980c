"""Inputs of a cell, made on the device from the seed.

:func:`make_world` is the repository's synthetic world (a continent with a
wavy west coast and two islands, fractional land, orography and its
sub-grid spread on land, near-surface potential temperature and winds with
seeded noise) written in torch, so that a run makes its fields on the card
in a few large calls.  The coastline's geometry is fixed by the grid's
shape alone, so every seed gives the same coast, coastal band, ring radius
and work; the seed moves only the values.  Sea ice is a band of rows at
the pole end of the grid whose edge the traffic moves (:func:`ice_field`).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def grid(spec: dict):
    """``(lon, lat)`` float32 host vectors of a configuration's ``grid``:
    ``{"nlat", "nlon", "lat0", "lat1", "lon0", "lon1"}``, latitudes from
    lat0 to lat1 inclusive, longitudes from lon0 to lon1 exclusive."""
    lat = np.linspace(spec["lat0"], spec["lat1"], spec["nlat"],
                      dtype=np.float32)
    lon = np.linspace(spec["lon0"], spec["lon1"], spec["nlon"],
                      endpoint=False, dtype=np.float32)
    return lon, lat


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_world(nlat, nlon, g: torch.Generator, device):
    """The static fields ``(lsm, z, std)`` (nlat, nlon) float32."""
    f = torch.float32
    y = torch.arange(nlat, dtype=f, device=device)[:, None]
    x = torch.arange(nlon, dtype=f, device=device)[None, :]
    coastx = (0.55 * nlon + 0.08 * nlon * torch.sin(2 * math.pi * y / nlat * 2.3)
              + 0.03 * nlon * torch.sin(2 * math.pi * y / nlat * 7.1))
    land = (x > coastx).to(f)
    for cy, cx, r in ((int(0.3 * nlat), int(0.25 * nlon), 0.05),
                      (int(0.7 * nlat), int(0.15 * nlon), 0.03)):
        land = torch.where((y - cy) ** 2 + (x - cx) ** 2 < (r * nlon) ** 2,
                           1.0, land)
    r3 = torch.rand((3, nlat, nlon), generator=g, device=device)
    lsm = land * (0.6 + 0.4 * r3[0])
    return lsm, 700.0 * lsm * r3[1], 110.0 * lsm * r3[2]


def noise(shape, scale, mean, g, device):
    """``mean + scale * N(0, 1)`` of ``shape``, float32."""
    return mean + scale * torch.randn(shape, generator=g, device=device)


def ice_field(nlat, nlon, edge_rows: int, device):
    """Sea ice of 0.8 over the first ``edge_rows`` rows (the pole end)."""
    ci = torch.zeros((nlat, nlon), dtype=torch.float32, device=device)
    ci[:edge_rows] = 0.8
    return ci


def pressure_levels(nlev: int, surface_pa: float, top_pa: float, device):
    """``nlev`` pressure levels, evenly from ``surface_pa`` to ``top_pa``."""
    return torch.linspace(surface_pa, top_pa, nlev, device=device)


def pressure_3d(nlev, z, g, device, top_eta=0.01):
    """A 3-D pressure (nlev, nlat, nlon) on hybrid-like levels: surface
    pressure falling with orography (scale height 8.4 km) with seeded
    2 hPa noise, times eta from 1 at the surface to ``top_eta``, the
    levels packed towards the surface as a model's are."""
    nlat, nlon = z.shape
    ps = (101325.0 * torch.exp(-z / 8434.0)
          + 200.0 * torch.randn((nlat, nlon), generator=g, device=device))
    s = torch.linspace(0.0, 1.0, nlev, device=device)
    eta = 1.0 - (1.0 - top_eta) * s ** 1.5
    return eta[:, None, None] * ps[None]
