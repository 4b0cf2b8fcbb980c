"""Grid description for the lat-lon sphere (host-side NumPy).

A NumPy copy of the JAX package's ``core/grid.py``, so the port stands
without it.  ``Grid`` owns the concrete coordinate vectors; the integers
derived from them (the ``k`` search radius of the distance transform, the
ring-search bound) are Python ints, computed once on the host.

Float32 discipline: the reference Fortran uses default ``real`` (32-bit)
with ``pi = 3.1415926`` and ``R = 6370.9989`` km (``sobel.f90:115-116``).
Every derived scalar is computed in float32 with the same operation order,
so the truncation ``k = int(maxdist / dx)`` (``sobel.f90:137``) lands on the
same integer.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Exact float32 constants of the reference (sobel.f90:115-118).
EARTH_RADIUS_KM = np.float32(6370.9989)
PI_F32 = np.float32(3.1415926)
DEG2RAD_F32 = PI_F32 / np.float32(180.0)
RAD2DEG_F32 = np.float32(180.0) / PI_F32


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static lat-lon grid metadata.

    lon : (nlon,) float32 — longitudes in degrees (any branch; values > 180
        are re-branched to (-180, 180] for distances, ``sobel.f90:165-174``).
    lat : (nlat,) float32 — latitudes in degrees, ascending or descending.
    """

    lon: np.ndarray
    lat: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "lon", np.asarray(self.lon, np.float32))
        object.__setattr__(self, "lat", np.asarray(self.lat, np.float32))

    @property
    def nlon(self) -> int:
        return int(self.lon.shape[0])

    @property
    def nlat(self) -> int:
        return int(self.lat.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        """Field shape (nlat, nlon): row-major, lat leading."""
        return (self.nlat, self.nlon)

    @cached_property
    def lam(self) -> np.ndarray:
        """Longitudes in radians (``sobel.f90:131``)."""
        return (DEG2RAD_F32 * self.lon).astype(np.float32)

    @cached_property
    def phi(self) -> np.ndarray:
        """Latitudes in radians (``sobel.f90:130``)."""
        return (DEG2RAD_F32 * self.lat).astype(np.float32)

    @cached_property
    def lon_branched(self) -> np.ndarray:
        """Longitude in radians re-branched to (-180, 180] degrees
        (``sobel.f90:165-174``)."""
        lon = self.lon
        return np.where(
            lon > np.float32(180.0),
            DEG2RAD_F32 * (lon - np.float32(360.0)),
            DEG2RAD_F32 * lon,
        ).astype(np.float32)

    def cell_diag_km_at70(self) -> np.float32:
        """Haversine length of one diagonal grid step at the latitude
        closest to 70 degrees (``sobel.f90:129-136``)."""
        lat, phi, lam = self.lat, self.phi, self.lam
        # Fortran: tlat = minloc(abs(70 - lat)), 1-based; phi1(tlat+1) is
        # the next element.
        tlat = int(np.argmin(np.abs(np.float32(70.0) - lat)))
        if tlat + 1 >= lat.shape[0]:  # degenerate tiny grids
            tlat = lat.shape[0] - 2
        dphi = np.float32(phi[tlat + 1] - phi[tlat])
        dlam = np.float32(lam[1] - lam[0])
        a = np.float32(
            np.sin(dphi / 2, dtype=np.float32) ** 2
            + (
                np.cos(phi[tlat + 1], dtype=np.float32)
                * (
                    np.cos(phi[tlat], dtype=np.float32)
                    * np.sin(dlam / 2, dtype=np.float32) ** 2
                )
            )
        )
        dx = EARTH_RADIUS_KM * np.float32(2.0) * np.arctan2(
            np.sqrt(a, dtype=np.float32),
            np.sqrt(np.float32(1.0) - a, dtype=np.float32),
            dtype=np.float32,
        )
        return np.float32(dx)

    def search_radius_cells(self, maxdist_km: float) -> int:
        """``k = int(maxdist / dx)`` of ``sobel.f90:137`` as a Python int."""
        dx = self.cell_diag_km_at70()
        return int(np.float32(maxdist_km) / dx)

    @staticmethod
    def regular(nlat: int, nlon: int, lat0=-90.0, lat1=90.0, lon0=0.0,
                lon1=360.0, descending_lat: bool = False) -> "Grid":
        """A regular grid: endpoint-exclusive lon, endpoint-inclusive lat."""
        lat = np.linspace(lat0, lat1, nlat, dtype=np.float32)
        if descending_lat:
            lat = lat[::-1].copy()
        lon = np.linspace(lon0, lon1, nlon, endpoint=False, dtype=np.float32)
        return Grid(lon=lon, lat=lat)
