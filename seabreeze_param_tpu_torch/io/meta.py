"""Static metadata, input-series discovery, and CF output writing; a copy
of ``seabreeze_param_tpu.io.meta`` on top of the port's :mod:`.netcdf`
(so the outputs are classic netCDF).

Capability-parity with the reference ``Meta``
(``python_wrapper/seabreezediag/configdir.py:15-181``):

  * load the static fields (land fraction, orography ``z``, sub-grid
    orography std) plus the lon/lat vectors from netCDF, with the
    reference's rank fallback ``[0,0,:,:] -> [0,:,:] -> [:]``
    (``configdir.py:42-54``);
  * discover the dated input-file series between ``start`` and ``end``,
    supporting the daily (``prefix_var_YYYY_MM_DD.nc``) and monthly
    (``prefix_var_YYYY_MM.nc``) layouts under ``datadir/YYYY/``
    (``configdir.py:82-119``);
  * write CF-style netCDF output with per-variable metadata and the
    2.0e20 missing value (``configdir.py:121-181``), append-mode when the
    file exists.
"""
from __future__ import annotations

import glob
import os
from datetime import datetime, timedelta

import numpy as np

from .netcdf import Dataset, date2num

# Output-variable metadata table (configdir.py:135-140).
VAR_METADATA = {
    "thc": dict(name="Thermal Heating Contrast Between Land and Ocean",
                units="K"),
    "sb_con": dict(name="Subgrid Sea-Breeze Convergence", units=" "),
    "windspeed": dict(name="Coastal Windspeed", units="m/s"),
    "winddir": dict(name="Coastal Wind Direction", units="deg"),
    "temp": dict(name="2M Temperture", units="degC"),
    # new in this framework: the explicit sea-level temperature output
    # (the reference's out[1] returned under the name "thc", SURVEY §3.3)
    "t0": dict(name="Sea-Level Temperature (Moist Adiabatic Descent)",
               units="K"),
}

MISSING = np.float32(2.0e20)
TIME_UNITS = "Seconds since 1970-01-01 00:00:00"
DATE_FMT = "%Y-%m-%d_%H:%M"


class Meta:
    """Static run metadata resolved from a :class:`~..io.config.Config`.

    Attributes after construction: ``landfrac``, ``z``, ``std`` (2-D float
    arrays), ``lon``, ``lat`` (1-D), ``start``/``end`` (datetime),
    ``datadir``, ``prefix``, ``vtheta``/``vu``/``vv``/``vpres``,
    ``dates`` (list of date strings with all inputs present).
    """

    def __init__(self, C):
        for fn_key, attr in (("landfracfile", "landfrac"), ("topofile", "z"),
                             ("orofile", "std")):
            path = os.path.expanduser(str(C[fn_key]))
            with Dataset(path) as f:
                var_name = C[f"v{attr}" if attr != "landfrac" else
                             "vlandfrac"]
                setattr(self, attr, _read_2d(f.variables[var_name]))
                self.lon = np.array(f.variables[C.vlon][:])
                self.lat = np.array(f.variables[C.vlat][:])
        self.start = datetime.strptime(C.start, DATE_FMT)
        self.end = datetime.strptime(C.end, DATE_FMT)
        self.datadir = os.path.expanduser(str(C.datadir))
        for key in ("vtheta", "prefix", "vpres", "vu", "vv"):
            setattr(self, key, C[key])
        self.dates = self._discover_dates()

    # -- input series discovery ---------------------------------------
    def _discover_dates(self):
        """List of 'YYYY_MM[_DD]' strings for which all inputs exist."""
        probe_day = os.path.join(
            self.datadir, f"{self.start.year:04d}",
            self.prefix + "*" + self.start.strftime("%Y_??_??.nc"))
        if glob.glob(probe_day):
            daily = True
        else:
            probe_mon = os.path.join(
                self.datadir, f"{self.start.year:04d}",
                self.prefix + "*" + self.start.strftime("%Y_??.nc"))
            if not glob.glob(probe_mon):
                raise ValueError(
                    "Only daily or monthly file-format is supported\n")
            daily = False

        dates, ts = [], self.start
        while ts < self.end:
            tstring = ts.strftime("%Y_%m_%d" if daily else "%Y_%m")
            pattern = os.path.join(self.datadir, f"{ts.year:04d}",
                                   f"{self.prefix}*_{tstring}.nc")
            if tstring not in dates and all(
                    os.path.isfile(pattern.replace("*", v))
                    for v in (self.vv, self.vu, self.vtheta)):
                dates.append(tstring)
            ts += timedelta(days=1)
        return dates

    def input_path(self, var: str, tstring: str) -> str:
        """Path of one dated input file (test_run.py:21,28 pattern)."""
        year = tstring.split("_")[0]
        return os.path.join(self.datadir, year,
                            f"{self.prefix}{var}_{tstring}.nc")

    # -- CF output ------------------------------------------------------
    def create_nc(self, data, fname, varname, times, add=""):
        """Write/append one (time, lat, lon) field as CF netCDF
        (configdir.py:121-181 semantics; missing value 2.0e20)."""
        mode = "a" if os.path.isfile(fname) else "w"
        meta = VAR_METADATA[varname]
        with Dataset(fname, mode) as f:
            for dim in ("lat", "lon", "time"):
                try:
                    size = None if dim == "time" else len(getattr(self, dim))
                    f.createDimension(dim, size)
                    f.createVariable(dim, "i" if dim == "time" else "f",
                                     (dim,))
                except RuntimeError:
                    pass
            v = f.variables
            for name, attrs in (
                    ("lon", dict(units="degrees_east", axis="X",
                                 long_name="Longitude")),
                    ("lat", dict(units="degrees_north", axis="Y",
                                 long_name="Latitude")),
                    ("time", dict(units=TIME_UNITS, axis="T",
                                  long_name="Time"))):
                for k, val in attrs.items():
                    v[name].setncattr(k, val)
            v["lon"][:] = self.lon
            v["lat"][:] = self.lat
            v["time"][:] = date2num(times, TIME_UNITS)
            try:
                f.createVariable(varname, "f", ("time", "lat", "lon"))
            except RuntimeError:
                pass
            out = f.variables[varname]
            out[:] = np.asarray(data, np.float32)
            out.setncattr("long_name", meta["name"] + add)
            out.setncattr("units", meta["units"])
            out.setncattr("grid", "lonlat")
            out.setncattr("missing_value", MISSING)


def _read_2d(var):
    """Rank fallback [0,0,:,:] -> [0,:,:] -> [:] (configdir.py:42-54)."""
    for key in ((0, 0, slice(None), slice(None)),
                (0, slice(None), slice(None)), slice(None)):
        try:
            return np.array(var[key])
        except (IndexError, ValueError):
            continue
    raise ValueError(f"cannot read 2-D field from {var.name!r}")
