"""Science and runtime parameters (host-side).

A copy of the JAX package's ``core/params.py``, so the port stands without
it.  Defaults are the reference's f2py defaults
(``seabreeze_diag_python.f90:137-141``, ``sobel.f90:96``) and its Fortran
parameter constants (``seabreeze_diag_python.f90:125-126``), bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Fortran parameter constants, seabreeze_diag_python.f90:125-126.
RAD2DEG_TRIGGER = np.float32(57.2957)       # NOT 180/pi: the reference's value
GMMA = np.float32(-0.0060956)               # K/m moist adiabatic lapse rate
MISSING_VALUE = np.float32(2.0e20)          # seabreeze_diag_python.f90:173
FAR_SENTINEL_KM = np.float32(12000.0)       # sobel.f90:145,188


@dataclasses.dataclass(frozen=True)
class Params:
    """Trigger-scheme parameters: target_plev=700 hPa, thresh_wind=11 m/s,
    thresh_winddir=90 deg, thresh_windch=5 m/s, thresh_thc=0.75 K,
    target_time=6 h, timestep=24 min, maxdist=180 km."""

    target_plev: float = 700.0      # hPa; wind evaluated at nearest level
    thresh_wind: float = 11.0       # m/s: mean wind speed must be below
    thresh_winddir: float = 90.0    # deg: wind direction change below
    thresh_windch: float = 5.0      # m/s: wind speed change below
    thresh_thc: float = 0.75        # K: |thermal heating contrast| above
    target_time: float = 6.0        # h: wind state update cadence
    timestep: float = 24.0          # min: input data timestep
    maxdist: float = 180.0          # km: coastal influence distance

    # Reference quirks, on by default.  The Fortran lon index map
    # max(1, modulo(j, nlons)) of sobel.f90:68 and
    # seabreeze_diag_python.f90:202 (off = clean periodic wraparound).
    exact_lon_indexing: bool = True
    # The `do i=1,nlats-1` bound of seabreeze_diag_python.f90:165: the last
    # latitude row is never computed (zeros out, state frozen).
    skip_last_lat_row: bool = True
    # Extra ring-search radius beyond the provable k+2 bound.
    ring_search_margin: int = 2

    @property
    def timestep_seconds(self) -> np.float32:
        """seabreeze_diag_python.f90:146: minutes to seconds, f32."""
        return np.float32(self.timestep) * np.float32(60.0)

    @property
    def target_time_seconds(self) -> np.float32:
        """seabreeze_diag_python.f90:147: hours to seconds, f32."""
        return np.float32(self.target_time) * np.float32(60.0) ** 2

    @property
    def target_plev_pa(self) -> np.float32:
        """seabreeze_diag_python.f90:148: hPa to Pa, f32."""
        return np.float32(self.target_plev) * np.float32(100.0)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
