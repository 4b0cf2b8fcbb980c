"""Minimal self-contained netCDF layer; counterpart of
``seabreeze_param_tpu.io.netcdf``, with the same surface (the slice of the
netCDF4 API the reference exercises: ``Dataset(...).variables[name][...]``,
``.units``, ``createDimension``, ``createVariable``, ``setncattr``).

Backends, chosen by what the machine has (a GPU host may lack h5py):

  * **write/append**: classic netCDF (CDF-2, 64-bit offsets) through
    ``scipy.io.netcdf_file``.  The JAX package writes netCDF-4 (HDF5)
    through h5py instead; both are CF netCDF, and each package reads the
    other's files.
  * **read, classic files**: the native mmap reader
    (:mod:`.native_nc`, built from ``native/ncreader.cc``), else scipy.
    Through scipy the arrays come back big-endian (``>f4``), as in the JAX
    package; the port's entry points convert host arrays to native float32.
  * **read, netCDF-4 (HDF5) files**: h5py, only where it imports;
    otherwise ``ImportError`` naming h5py.

``missing_value``/``_FillValue`` give a ``np.ma`` array where they match,
as netCDF4 does (the reference relies on masked sea-ice arrays,
``__init__.py:225``); assigning to a variable on the unlimited axis appends
records.  The calendar helpers ``date2num``/``num2date`` are copies of the
JAX package's.
"""
from __future__ import annotations

import os
import re
from datetime import datetime, timedelta

import numpy as np

_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "secs": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0, "mins": 60.0,
    "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "hrs": 3600.0, "h": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
}

_UNITS_RE = re.compile(
    r"^\s*(\w+)\s+since\s+(\d{1,4})-(\d{1,2})-(\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2}(?:\.\d*)?))?)?", re.IGNORECASE)

#: HDF5 superblock signature, at offset 0 or 512 * 2**n (HDF5 spec).
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

#: netCDF4-style type codes -> the classic types scipy writes.
_TYPES = {"f": np.float32, "d": np.float64, "i": np.int32}


def _parse_units(units: str):
    m = _UNITS_RE.match(units)
    if not m:
        raise ValueError(f"unparseable time units: {units!r}")
    scale = _UNIT_SECONDS.get(m.group(1).lower())
    if scale is None:
        raise ValueError(f"unknown time unit {m.group(1)!r} in {units!r}")
    y, mo, d = int(m.group(2)), int(m.group(3)), int(m.group(4))
    hh = int(m.group(5) or 0)
    mm = int(m.group(6) or 0)
    ss = float(m.group(7) or 0.0)
    return scale, datetime(y, mo, d, hh, mm) + timedelta(seconds=ss)


def date2num(dates, units: str):
    """datetime(s) -> numeric time axis in the given CF units."""
    scale, epoch = _parse_units(units)
    one = isinstance(dates, datetime)
    seq = [dates] if one else list(dates)
    out = np.array([(t - epoch).total_seconds() / scale for t in seq])
    return out[0] if one else out


def num2date(values, units: str):
    """Numeric CF time axis -> datetime objects (standard calendar)."""
    scale, epoch = _parse_units(units)
    arr = np.asarray(values, dtype=np.float64)
    flat = [epoch + timedelta(seconds=float(v) * scale) for v in arr.ravel()]
    if arr.ndim == 0:
        return flat[0]
    return np.array(flat, dtype=object).reshape(arr.shape)


def is_hdf5(path) -> bool:
    """Whether ``path`` holds an HDF5 (netCDF-4) file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        offset = 0
        while offset + len(_HDF5_MAGIC) <= size:
            f.seek(offset)
            if f.read(len(_HDF5_MAGIC)) == _HDF5_MAGIC:
                return True
            offset = 512 if offset == 0 else 2 * offset
    return False


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a netCDF-4 (HDF5) file needs h5py, which "
                          "is not installed; write or convert the file as "
                          "classic netCDF") from e
    return h5py


# ---------------------------------------------------------------------------
class Variable:
    """Lazy variable handle: slicing reads from disk; netCDF attributes are
    plain Python attributes (``v.units``); masked where ``missing_value`` /
    ``_FillValue`` matches."""

    def __init__(self, ds, name, raw, backend):
        self._ds = ds
        self.name = name
        self._raw = raw
        self._backend = backend

    @property
    def shape(self):
        return tuple(self._raw.shape)

    @property
    def dtype(self):
        return np.dtype(self._raw.dtype)

    @property
    def dimensions(self):
        if self._backend == "h5":
            dims = []
            for i, dim in enumerate(self._raw.dims):
                names = [n if isinstance(n, str)
                         else os.path.basename(getattr(n, "name", "") or "")
                         for n in dim]
                dims.append(names[0] if names else f"phony_dim_{i}")
            return tuple(dims)
        return tuple(self._raw.dimensions)

    def ncattrs(self):
        if self._backend == "h5":
            return [k for k in self._raw.attrs
                    if not k.startswith(("_Netcdf4", "DIMENSION", "CLASS",
                                         "NAME", "REFERENCE_LIST"))]
        if self._backend == "native":
            return sorted(self._raw.attrs())
        return sorted(self._raw._attributes)

    def __getattr__(self, key):
        try:
            if self._backend == "h5":
                val = self._raw.attrs[key]
            elif self._backend == "native":
                val = self._raw.att(key)
                if val is None:
                    raise KeyError(key)
            else:
                val = self._raw._attributes[key]
        except KeyError:
            raise AttributeError(key) from None
        if isinstance(val, bytes):
            return val.decode()
        return val

    def setncattr(self, key, value):
        self._ds._writable()
        setattr(self._raw, key, value)

    __setattr__ = object.__setattr__  # attrs on the handle stay Python-side

    def __getitem__(self, key):
        data = self._raw[key]
        if self._backend == "scipy":
            data = np.array(data)  # detach from the file object
        fill = None
        for attr in ("missing_value", "_FillValue"):
            try:
                fill = getattr(self, attr)
                break
            except AttributeError:
                continue
        if fill is not None and np.issubdtype(np.asarray(data).dtype,
                                              np.number):
            mask = np.isclose(data, np.asarray(fill, data.dtype))
            if mask.any():
                return np.ma.masked_array(data, mask=mask)
        return data

    def __setitem__(self, key, value):
        """Write; on a record variable (the unlimited axis first) records
        past the end are appended."""
        self._ds._writable()
        self._raw[key] = np.asarray(value)

    def __len__(self):
        return self.shape[0]


class Dataset:
    """netCDF dataset: ``Dataset(path)`` to read (classic or netCDF-4),
    ``mode='w'``/``'a'`` to write or append classic netCDF."""

    def __init__(self, filename, mode="r"):
        self.filename = os.path.expanduser(str(filename))
        self.mode = mode
        self._scipy = None
        self._native = None
        self._h5 = None
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: want 'r', 'w' or 'a'")
        if mode != "w" and is_hdf5(self.filename):
            if mode == "a":
                raise OSError(f"{self.filename}: netCDF-4 (HDF5) file; this "
                              "package appends to classic netCDF only")
            self._h5 = _h5py().File(self.filename, "r")
            return
        if mode == "r":
            from . import native_nc
            if native_nc.available():
                try:
                    self._native = native_nc.NativeNCFile(self.filename)
                except IOError:
                    self._native = None
            if self._native is not None:
                return
        from scipy.io import netcdf_file
        self._scipy = netcdf_file(self.filename, mode, mmap=False,
                                  version=2)

    # -- reference API slice ------------------------------------------
    @property
    def variables(self):
        if self._h5 is not None:
            h5py = _h5py()
            return {name: Variable(self, name, node, "h5")
                    for name, node in self._h5.items()
                    if isinstance(node, h5py.Dataset)}
        if self._native is not None:
            return {name: Variable(self, name, var, "native")
                    for name, var in self._native.variables.items()}
        return {name: Variable(self, name, var, "scipy")
                for name, var in self._scipy.variables.items()}

    @property
    def dimensions(self):
        if self._h5 is not None:
            return {name: node.shape[0] for name, node in self._h5.items()
                    if node.attrs.get("CLASS") == b"DIMENSION_SCALE"}
        if self._native is not None:
            from . import native_nc
            return native_nc.dimensions(self._native._h)
        return dict(self._scipy.dimensions)

    def _writable(self):
        if self._scipy is None or self.mode == "r":
            raise OSError(f"{self.filename}: opened read-only")
        return self._scipy

    def createDimension(self, name, size=None):
        nc = self._writable()
        if name in nc.dimensions:
            raise RuntimeError(f"dimension {name!r} exists")
        if size is None and nc._dims:
            # scipy takes the unlimited dimension only as the first one;
            # the classic format allows it anywhere, and netCDF4 in any
            # order, so it goes in front of the ones already defined.
            if None in nc.dimensions.values():
                raise RuntimeError("only one unlimited dimension")
            nc.dimensions[name] = None
            nc._dims.insert(0, name)
            return
        nc.createDimension(name, size)

    def createVariable(self, name, datatype, dimensions=()):
        nc = self._writable()
        if name in nc.variables:
            raise RuntimeError(f"variable {name!r} exists")
        var = nc.createVariable(name, _TYPES.get(datatype, datatype),
                                tuple(dimensions))
        return Variable(self, name, var, "scipy")

    def close(self):
        for f in (self._h5, self._scipy, self._native):
            if f is not None:
                f.close()
        self._h5 = self._scipy = self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
