"""The port's IO layer (``seabreeze_param_tpu_torch.io``, ``utils.layout``,
``core.fields``) against the JAX package's on the CPU, and the port's entry
points fed big-endian arrays, as classic netCDF read through scipy gives
them.

One synthetic tree (the layout of ``tests/test_io.py``: daily files, static
files with the rank fallback, a run.conf) is written by the port's writer
(classic netCDF through scipy) and read by both packages; the same data
written by the JAX package's writer (netCDF-4 through h5py) first holds the
JAX package's reading of the port's tree to its reading of its own.
"""
import contextlib
import hashlib
import os
import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from seabreeze_param_tpu import api as japi
from seabreeze_param_tpu import coupling as jcoup
from seabreeze_param_tpu import io as jio
from seabreeze_param_tpu.core import fields as jfields
from seabreeze_param_tpu.core.grid import Grid as JGrid
from seabreeze_param_tpu.core.state import TriggerState as JState
from seabreeze_param_tpu.utils import layout as jlayout
from seabreeze_param_tpu_torch import api as tapi
from seabreeze_param_tpu_torch import coupling as tcoup
from seabreeze_param_tpu_torch import io as tio
from seabreeze_param_tpu_torch.core import fields as tfields
from seabreeze_param_tpu_torch.core.grid import Grid
from seabreeze_param_tpu_torch.core.state import TriggerState
from seabreeze_param_tpu_torch.io import native_nc as tnative
from seabreeze_param_tpu_torch.utils import layout as tlayout
from tests.test_torch_coupling import _check_step, _close, _fields, _same_wind

F = np.float32
ROOT = Path(__file__).resolve().parents[1]
PREBUILT = ROOT / "native" / "libncreader.so"


# -- the synthetic tree ------------------------------------------------------
def _write_static(ds_cls, path, lon, lat, fields, extra_rank=0):
    """A static file; ``extra_rank`` leading singleton dims exercise the
    rank fallback of ``Meta``."""
    with ds_cls(path, "w") as f:
        f.createDimension("longitude", len(lon))
        f.createDimension("latitude", len(lat))
        f.createVariable("longitude", "f", ("longitude",))
        f.createVariable("latitude", "f", ("latitude",))
        f.variables["longitude"][:] = lon
        f.variables["latitude"][:] = lat
        lead = ("time_d", "lev_d")[:extra_rank]
        for dname in lead:
            f.createDimension(dname, 1)
        for name, data in fields.items():
            v = f.createVariable(name, "f", lead + ("latitude", "longitude"))
            v[:] = data.reshape((1,) * extra_rank + data.shape)


def _write_input(ds_cls, path, varname, data, pres, times, units):
    with ds_cls(path, "w") as f:
        f.createDimension("time", None)
        f.createDimension("level", data.shape[1] if data.ndim == 4 else 1)
        f.createDimension("latitude", data.shape[-2])
        f.createDimension("longitude", data.shape[-1])
        for nm, typ in (("time", "d"), ("level", "f")):
            f.createVariable(nm, typ, (nm,))
        f.variables["time"][:] = tio.date2num(times, units)
        f.variables["time"].setncattr("units", units)
        f.variables["level"][:] = pres if data.ndim == 4 else pres[:1]
        dims = (("time", "level", "latitude", "longitude") if data.ndim == 4
                else ("time", "latitude", "longitude"))
        f.createVariable(varname, "f", dims)[:] = data


def write_conf(tree, end_day):
    """A run.conf for the tree whose series ends before ``end_day``."""
    root = tree["root"]
    conf = root / f"run_{end_day}.conf"
    conf.write_text(f"""datadir = {root}/data
landfracfile = {root}/data/static_slm.nc
topofile = {root}/data/static_topo.nc
orofile = {root}/data/static_topo.nc
prefix = Synth_
vtheta = t2m
vu = u
vv = v
vlon = longitude
vlat = latitude
vpres = level
vci = ci
vlandfrac = lsm
vz = z
vstd = sdfor
vtime = time
plev = 700
start = 1987-01-01_00:00
end = 1987-01-{end_day:02d}_00:00
""")
    return conf


def build_tree(root, ds_cls=tio.Dataset, nlat=24, nlon=32, nlev=3, nt=4,
               ndays=2, ice=False):
    """``tests/test_io.py::_build_synthetic_run`` written by ``ds_cls``:
    static files (rank-4 land fraction, rank-2 orography), ``ndays`` daily
    files of ``nt`` six-hourly steps, the same seed and draws.  ``ice``
    puts sea ice on the top rows from the second day on, so the coastline
    moves between files."""
    root = Path(root)
    datadir = root / "data" / "1987"
    datadir.mkdir(parents=True)
    rng = np.random.default_rng(11)
    lon = np.linspace(0, 360, nlon, endpoint=False).astype(F)
    lat = np.linspace(40, -40, nlat).astype(F)
    y, x = np.mgrid[0:nlat, 0:nlon]
    lsm = (x > 0.5 * nlon).astype(F) * (0.7 + 0.3 * rng.random((nlat, nlon)))
    z = (300.0 * lsm).astype(F)
    std = (80.0 * lsm).astype(F)
    pres = np.array([1000.0, 700.0, 500.0], F)[:nlev]
    _write_static(ds_cls, root / "data" / "static_slm.nc", lon, lat,
                  {"lsm": lsm}, extra_rank=2)
    _write_static(ds_cls, root / "data" / "static_topo.nc", lon, lat,
                  {"z": z, "sdfor": std})
    units = "hours since 1987-01-01 00:00:00"
    days, series = [], []
    for day in range(1, ndays + 1):
        times = [datetime(1987, 1, day, 6 * i) for i in range(nt)]
        t2m = 288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon)).astype(F)
        uu = 5.0 * rng.standard_normal((nt, nlev, nlat, nlon)).astype(F)
        vv = 5.0 * rng.standard_normal((nt, nlev, nlat, nlon)).astype(F)
        ci = np.zeros((nt, nlat, nlon), F)
        if ice and day > 1:
            ci[:, :2, :] = 0.8
        tag = f"1987_01_{day:02d}"
        for name, data in (("t2m", t2m), ("u", uu), ("v", vv), ("ci", ci)):
            _write_input(ds_cls, datadir / f"Synth_{name}_{tag}.nc", name,
                         data, pres, times, units)
        days.append(tag)
        series.append(dict(theta=t2m, u=uu, v=vv, ci=ci, times=times))
    tree = dict(root=root, days=days, lsm=lsm.astype(F), z=z, std=std, lon=lon,
                lat=lat, pres=pres, series=series)
    tree["conf"] = write_conf(tree, ndays + 1)
    return tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(tmp_path_factory.mktemp("torch_tree"))


@pytest.fixture(scope="module")
def h5_tree(tmp_path_factory):
    return build_tree(tmp_path_factory.mktemp("jax_tree"), jio.Dataset)


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _read_all(ds_cls, path):
    """name -> (data, attributes, dimensions) of every variable."""
    out = {}
    with ds_cls(str(path)) as f:
        for name, var in f.variables.items():
            out[name] = (var[:], {k: getattr(var, k) for k in var.ncattrs()},
                         tuple(var.dimensions))
    return out


def _tree_files(tree):
    return sorted((tree["root"] / "data").rglob("*.nc"))


@contextlib.contextmanager
def _jax_native_off():
    """The JAX package reading classic files through scipy: its native
    reader returns a (1, 1, nlat, nlon) static field whole, whatever the
    index of ``Meta``'s rank fallback."""
    from seabreeze_param_tpu.io import native_nc as jnative
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        yield


# -- copies held bit-equal to the JAX package ---------------------------------
CONF_TEXT = """# a comment line
filename = 'foo.nc' # quoted string
variable = bar # trailing comment
 x1 = 9.0 # float
x2 =10  # int
active = true
off = False
nothing = None
times = 1,2,3 # tuple
[section-like junk]
datadir = $MYDATA/sub
"""


@pytest.mark.parametrize("case", ["parse", "unset_env", "missing_file"])
def test_config_copy_matches_jax(case, tmp_path, monkeypatch):
    """The parser cases of ``tests/test_io.py``: equal dicts, equal repr,
    equal errors."""
    monkeypatch.setenv("MYDATA", "/data/root")
    monkeypatch.delenv("UNSET_VAR_XYZ", raising=False)
    p = tmp_path / "t.conf"
    if case == "parse":
        p.write_text(CONF_TEXT)
        got, ref = tio.Config(p), jio.Config(p)
        assert dict(got) == dict(ref) and repr(got) == repr(ref)
        assert got.times == (1.0, 2.0, 3.0) and got.datadir == "/data/root/sub"
        assert got.get_default("vu") == ref.get_default("vu") == "u"
        with pytest.raises(AttributeError):
            got.missing_key
        assert tio.CONFIG_SCHEMA == jio.CONFIG_SCHEMA
        return
    want = KeyError
    if case == "unset_env":
        p.write_text("bad = $UNSET_VAR_XYZ/sub\n")
    else:
        p, want = tmp_path / "nope.conf", FileNotFoundError
    for cls in (tio.Config, jio.Config):
        with pytest.raises(want):
            cls(p)


def test_calendar_layout_and_fields_copies_match_jax():
    """``date2num``/``num2date``, ``c2f``/``f2c`` and the field registry,
    ``allocate`` and ``synthetic_world``: bit-equal."""
    times = [datetime(1987, 1, 1) + timedelta(hours=6 * i) for i in range(5)]
    for units in ("Seconds since 1970-01-01 00:00:00",
                  "hours since 1987-01-01", "days since 1900-1-1 6:00:30.5"):
        got, ref = tio.date2num(times, units), jio.date2num(times, units)
        np.testing.assert_array_equal(got, ref)
        assert tio.date2num(times[2], units) == jio.date2num(times[2], units)
        assert list(tio.num2date(got, units)) == list(
            jio.num2date(ref, units))
        assert tio.num2date(got[1], units) == jio.num2date(ref[1], units)
    with pytest.raises(ValueError):
        tio.date2num(times, "fortnights since 1987-01-01")
    a = np.arange(2 * 3 * 4, dtype=F).reshape(2, 3, 4)
    np.testing.assert_array_equal(tlayout.c2f(a), jlayout.c2f(a))
    np.testing.assert_array_equal(tlayout.f2c(tlayout.c2f(a)), a)
    assert tfields.REGISTRY == tuple(
        tfields.FieldSpec(**vars(s)) for s in jfields.REGISTRY)
    assert tfields.field_names("state") == jfields.field_names("state")
    for got, ref in ((tfields.allocate(12, 16, 5), jfields.allocate(12, 16, 5)),
                     (tfields.synthetic_world(24, 32, 3, 2, seed=4,
                                              polar_ice=True),
                      jfields.synthetic_world(24, 32, 3, 2, seed=4,
                                              polar_ice=True))):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- netCDF files across the packages ------------------------------------------
def test_jax_reads_port_tree_as_its_own(tree, h5_tree):
    """The JAX package reads the port-written classic tree exactly as it
    reads the same data through its own HDF5 writer: every variable's
    data, attributes and dimensions."""
    for cf, hf in zip(_tree_files(tree), _tree_files(h5_tree)):
        assert cf.name == hf.name
        classic, h5 = _read_all(jio.Dataset, cf), _read_all(jio.Dataset, hf)
        with jio.Dataset(cf) as f:
            # the HDF5 writer stores a dimension without a coordinate
            # variable as a dimension-scale dataset
            assert set(h5) - set(classic) <= set(f.dimensions), cf.name
        for name, got in classic.items():
            data, attrs, dims = h5[name]
            np.testing.assert_array_equal(got[0], data, err_msg=name)
            assert got[0].dtype == data.dtype, name
            assert got[1] == attrs, name
            # (the HDF5 reading names a coordinate variable's own
            # dimension phony_dim_0)
            assert got[2] == dims or got[2] == (name,), name


def test_port_reads_jax_hdf5_files(tree, h5_tree):
    """JAX-written netCDF-4 read by the port (through h5py) equals the
    port's reading of its own classic files."""
    for cf, hf in zip(_tree_files(tree), _tree_files(h5_tree)):
        classic, h5 = _read_all(tio.Dataset, cf), _read_all(tio.Dataset, hf)
        for name, (data, attrs, _) in h5.items():
            if name in classic:
                np.testing.assert_array_equal(classic[name][0], data)
                assert classic[name][1] == attrs


def test_hdf5_without_h5py_names_h5py(h5_tree):
    """Where h5py does not import (the card's machine), a netCDF-4 file
    raises an ImportError that names it; classic files still read."""
    code = f"""
import sys
sys.modules['h5py'] = None
from seabreeze_param_tpu_torch.io import Dataset
try:
    Dataset({str(_tree_files(h5_tree)[0])!r})
except ImportError as e:
    assert 'h5py' in str(e), e
    print('refused')
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "refused"


def test_native_reader_equals_scipy(tree, monkeypatch):
    """The native reader, built from ``native/ncreader.cc`` into
    ``build/native/``, reads every file of the tree as scipy does (whole
    variables, records, attributes, dimensions); the prebuilt
    ``native/libncreader.so`` is neither loaded by it nor changed."""
    before = _sha(PREBUILT)
    assert tnative.available()
    so = tnative.library_path()
    assert so.parent == ROOT / "build" / "native" and so.exists()
    for path in _tree_files(tree):
        with tio.Dataset(path) as f:
            assert f._native is not None
            dims = f.dimensions
            for var in f.variables.values():
                if var.dimensions[0] == "time" and len(var.shape) > 1:
                    np.testing.assert_array_equal(var[2], var[:][2])
                    np.testing.assert_array_equal(var[-1], var[:][-1])
                    np.testing.assert_array_equal(var[1:3], var[:][1:3])
                    with pytest.raises(IndexError):
                        var[var.shape[0]]
        native = _read_all(tio.Dataset, path)
        monkeypatch.setattr(tnative, "available", lambda: False)
        with tio.Dataset(path) as f:
            assert f._native is None
            # the unlimited dimension: None through scipy, its length here
            assert {k: v or dims[k] for k, v in f.dimensions.items()} == dims
        scipy_read = _read_all(tio.Dataset, path)
        monkeypatch.undo()
        assert native.keys() == scipy_read.keys()
        for name, (data, attrs, dimnames) in scipy_read.items():
            got = native[name]
            if data.dtype.kind == "f":
                assert data.dtype.byteorder == ">"        # scipy's reading
            np.testing.assert_array_equal(got[0], data, err_msg=name)
            assert got[2] == dimnames
            assert {k: np.asarray(v).tolist() for k, v in got[1].items()} \
                == {k: np.asarray(v).tolist() for k, v in attrs.items()}
    assert _sha(PREBUILT) == before


def test_meta_and_read_nc_match_jax(tree, h5_tree):
    """``Meta`` (rank fallback, dates, paths) and ``read_nc`` on the
    port-written tree equal to the JAX package's on its own tree and, for
    ``read_nc``, on the port's."""
    got, ref = tio.Meta(tio.Config(tree["conf"])), jio.Meta(jio.Config(
        h5_tree["conf"]))
    for name in ("landfrac", "z", "std", "lon", "lat"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_array_equal(got.landfrac, tree["lsm"])
    # the JAX package's own reading of the port's tree takes its native
    # reader, which drops the rank fallback's index (see the port's
    # ``NativeVar.__getitem__``); through scipy it reads the same
    with _jax_native_off():
        jref = jio.Meta(jio.Config(tree["conf"]))
    for name in ("landfrac", "z", "std", "lon", "lat"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(jref, name))
    assert got.dates == ref.dates == jref.dates == tree["days"]
    assert (got.start, got.end, got.datadir) == (jref.start, jref.end,
                                                 jref.datadir)
    tag = tree["days"][1]
    assert got.input_path("u", tag) == jref.input_path("u", tag)
    paths = [got.input_path(v, tag) for v in ("v", "u", "t2m", "ci")]
    g = tio.read_nc(*paths, vtheta="t2m", vpres="level")
    r = jio.read_nc(*paths, vtheta="t2m", vpres="level")
    try:
        assert g.dt == r.dt == 360.0
        assert list(g.time) == list(r.time) == tree["series"][1]["times"]
        np.testing.assert_array_equal(g.pres, r.pres)
        for key in ("u", "v", "theta", "ci"):
            np.testing.assert_array_equal(getattr(g, key)[:],
                                          getattr(r, key)[:])
        np.testing.assert_array_equal(g.u[:], tree["series"][1]["u"])
    finally:
        for f in list(g.nc.values()) + list(r.nc.values()):
            f.close()


def test_meta_rank_fallback_differs_from_jax_native_reader(tree):
    """A fault of the reference that the port does not copy: the JAX
    package's native reader returns a non-record variable whole whatever
    the index, so its ``Meta`` reads the (1, 1, nlat, nlon) land fraction
    of a classic file as 4-D and its driver refuses it.  The port's reader
    indexes, so its ``Meta`` gives the 2-D field.  The prebuilt
    ``native/libncreader.so`` stays unchanged."""
    from seabreeze_param_tpu.cli import run as jrun
    from seabreeze_param_tpu.io import native_nc as jnative
    before = _sha(PREBUILT)
    assert jnative.available() and tnative.available()
    ref = jio.Meta(jio.Config(tree["conf"]))
    assert np.shape(ref.landfrac) == (1, 1) + tree["lsm"].shape
    with pytest.raises(ValueError, match="lsm"):
        jrun.main(tree["conf"], progress=None)
    got = tio.Meta(tio.Config(tree["conf"]))
    np.testing.assert_array_equal(got.landfrac, tree["lsm"])
    np.testing.assert_array_equal(got.landfrac, ref.landfrac[0, 0])
    assert _sha(PREBUILT) == before


def test_create_nc_append_read_by_both(tree, tmp_path):
    """The port's CF writer: a second variable appends to the file; masked
    where the missing value is; both packages read it back bit-equal."""
    meta = tio.Meta(tio.Config(tree["conf"]))
    path = str(tmp_path / "out.nc")
    times = tree["series"][0]["times"][:2]
    field = np.random.default_rng(3).random((2, 24, 32)).astype(F)
    field[0, :3] = tio.MISSING
    meta.create_nc(field, path, "sb_con", times)
    meta.create_nc(field + 1.0, path, "thc", times, add=" (appended)")
    for ds_cls in (tio.Dataset, jio.Dataset):
        with ds_cls(path) as f:
            assert set(f.variables) >= {"sb_con", "thc", "lat", "lon", "time"}
            v = f.variables["sb_con"]
            assert v.units == " " and v.long_name.startswith("Subgrid")
            assert float(v.missing_value) == float(tio.MISSING)
            sb = v[:]
            assert isinstance(sb, np.ma.MaskedArray)
            np.testing.assert_array_equal(sb.mask, field == tio.MISSING)
            np.testing.assert_array_equal(np.ma.getdata(sb), field)
            assert f.variables["thc"].long_name.endswith("(appended)")
            np.testing.assert_array_equal(
                np.ma.getdata(f.variables["thc"][:]), field + 1.0)
            assert list(tio.num2date(f.variables["time"][:],
                                     f.variables["time"].units)) == times
            np.testing.assert_array_equal(f.variables["lat"][:], meta.lat)


# -- big-endian inputs ----------------------------------------------------------
def _be(a):
    return np.asarray(a).astype(">f4")


def _diag_args(c, nsteps=2):
    return (1, c["lsm"], c["z"], c["std"], c["lon"], c["lat"], c["p"],
            c["u_t"][:nsteps], c["v_t"][:nsteps], c["theta_t"][:nsteps],
            c["ci_t"][:nsteps])


def _state(c, seed=5):
    rng = np.random.default_rng(seed)
    shape = c["lsm"].shape
    return dict(thc=(290 + rng.standard_normal(shape)).astype(F),
                ws=(5 + rng.random(shape)).astype(F),
                wd=(360 * rng.random(shape) - 180).astype(F))


@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["single", "mesh2x2"])
def test_diag_takes_big_endian_arrays(global_case, mesh):
    """``diag`` fed ``>f4`` z, std, pres, ws, wd and thc (with state at
    tt = 15, a wind refresh) equals the same call with native arrays bit
    for bit, and the JAX ``diag`` fed the same big-endian arrays:
    per-step fields MISSING structure equal, then rtol 2e-5 / atol 2e-4;
    the state as ``tests/test_torch_pipeline.py`` holds it."""
    c = global_case
    args = list(_diag_args(c))
    args[0] = 15
    st = _state(c)
    kw = dict(full_output=True, mesh=mesh)
    native = tapi.diag(*args, device="cpu", ws=st["ws"], wd=st["wd"],
                       thc=st["thc"], **kw)
    be_args = list(args)
    for i in (2, 3, 6):                       # z, std, pres
        be_args[i] = _be(args[i])
    be_state = {k: _be(v) for k, v in st.items()}
    got = tapi.diag(*be_args, device="cpu", **be_state, **kw)
    assert got[0] == native[0] == 17
    for g, n in zip(got[1:5], native[1:5]):
        np.testing.assert_array_equal(g, n)
    for key in native[5]:
        np.testing.assert_array_equal(got[5][key], native[5][key])
    ref = japi.diag(*be_args, **be_state, **kw)
    assert ref[0] == got[0]
    if mesh is None:
        for key in ("sb_con", "t0", "windspeed", "winddir"):
            _close(got[5][key], np.asarray(ref[5][key]), key)
    else:
        from tests.test_torch_sharded import _assert_outputs_close
        _assert_outputs_close(got[5], {k: np.asarray(v)
                                       for k, v in ref[5].items()})
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-3)


def test_sea_breeze_diag_takes_big_endian_arrays(small_case):
    """The functional UM form fed ``>f4`` pressure, winds, theta, z, sigma,
    mask and the inout triple: bit-equal to native arrays, and to the JAX
    routine as ``tests/test_torch_coupling.py`` holds it; ``cumulus_mask``
    takes a big-endian sb_con."""
    c = small_case
    jg = JGrid(lon=c["lon"], lat=c["lat"])
    cdist = np.asarray(jcoup.CoupledTrigger(grid=jg).prepare_mask(
        c["lsm"], c["ci_t"][0]))
    st, theta, u, v, p = _fields(c, 15)
    args = [24.0 * 60.0, 15, p, u, v, theta, c["z"], c["std"], cdist,
            st["ws"], st["wd"], st["thc"]]
    grid = Grid(lon=c["lon"], lat=c["lat"])
    native = tcoup.sea_breeze_diag(*args, grid, device="cpu")
    be = args[:2] + [_be(a) for a in args[2:]]
    got = tcoup.sea_breeze_diag(*be, grid, device="cpu")
    for g, n in zip(got[:4], native[:4]):
        torch.testing.assert_close(g, n, rtol=0, atol=0)
    ref = jcoup.sea_breeze_diag(*be, jg)
    assert got[4] == ref[4] == tcoup.ERROR_NONE
    _check_step(TriggerState(16, got[3], got[1], got[2]), {"sb_con": got[0]},
                JState(16, ref[3], ref[1], ref[2]), {"sb_con": ref[0]},
                _same_wind(u, v, p))
    ct = tcoup.CoupledTrigger(grid=grid, device="cpu")
    torch.testing.assert_close(ct.prepare_mask(_be(c["lsm"]),
                                               _be(c["ci_t"][0])),
                               ct.prepare_mask(c["lsm"], c["ci_t"][0]),
                               rtol=0, atol=0)
    sb = got[0].numpy()
    torch.testing.assert_close(tcoup.cumulus_mask(_be(sb)),
                               tcoup.cumulus_mask(sb))
