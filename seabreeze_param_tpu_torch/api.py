"""Drop-in public API mirroring ``seabreezediag.diag``; counterpart of
``seabreeze_param_tpu.api``.

    tt, sb_con, thc, ws, wd = diag(tt, lsm, z, std, lon, lat, pres,
                                   u, v, t, ci, **kwargs)

Same positional order, keyword names and defaults, returns, state threading
and warnings as the reference (``python_wrapper/seabreezediag/
__init__.py:91-263``), on top of :class:`models.pipeline.TriggerPipeline`.
Extensions: ``device`` (the card by default), ``use_kernels``,
``full_output`` and ``mesh`` — the decomposed run
(:class:`parallel.sharded.ShardedPipeline`) with every shard on ``device``:
``None`` (default, no decomposition), ``'auto'``, ``'PYxPX'``, a
``(py, px)`` tuple or a :class:`parallel.mesh.ShardMesh`.  Returns host
float32 arrays; ``thc`` is, as in the reference, the sea-level temperature
t0.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .core.grid import Grid
from .core.params import Params
from .core.state import TriggerState
from .models.pipeline import TriggerPipeline
from .ops.ring_search import required_ring_radius_host

_PARAM_KEYS = ("target_plev", "thresh_wind", "thresh_winddir",
               "thresh_windch", "thresh_thc", "target_time", "timestep",
               "maxdist")

#: Pipelines keyed by (grid, params, device, kernels, ring bound, and for a
#: decomposed run the mesh shape and device), and the
#: sticky ring bound per (grid, params, device, kernels); least recently used
#: entries go first.  A pipeline caches its device distance tables, so a
#: batch run over many files on one grid builds them once.
_CACHE: OrderedDict = OrderedDict()
_CACHE_MAX = 16
CACHE_STATS = {"pipeline_hits": 0, "pipeline_misses": 0}


def clear_exec_cache():
    """Drop all cached pipelines and ring bounds."""
    _CACHE.clear()
    CACHE_STATS["pipeline_hits"] = 0
    CACHE_STATS["pipeline_misses"] = 0


def _cache_put(key, value):
    _CACHE[key] = value
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)


def _cached_pipeline(key, build):
    pipe = _CACHE.get(key)
    if pipe is None:
        CACHE_STATS["pipeline_misses"] += 1
        pipe = build()
    else:
        CACHE_STATS["pipeline_hits"] += 1
    _cache_put(key, pipe)
    return pipe


def _fill(ci):
    """``ci.filled(0)`` for masked arrays (__init__.py:225), else as-is."""
    if ci is None:
        return None
    if hasattr(ci, "filled"):
        return np.asarray(ci.filled(0), np.float32)
    return np.asarray(ci, np.float32)


def ring_radius(cdist0, params: Params, k: int) -> int:
    """:func:`required_ring_radius_host` on a frame widened only as far as
    needed: padded by about 4k cells first, and doubled while the result
    reaches the frame (a result below the frame width is exact)."""
    full = max(cdist0.shape)
    cap = min(full, max(8, 4 * k))
    while True:
        req = required_ring_radius_host(cdist0, params.maxdist,
                                        exact_lon=params.exact_lon_indexing,
                                        cap=cap)
        if req < cap or cap >= full:
            return req
        cap = min(full, 2 * cap)


def diag(tt, lsm, z, std, lon, lat, pres, *args, **kwargs):
    """See the module docstring and the reference docstring
    (``__init__.py:92-188``).

    Returns ``(tt, sb_con, thc, ws, wd)`` with ``sb_con`` of shape
    (T, nlat, nlon) (T=1 for 3-D input) and the three state fields 2-D.
    ``full_output=True`` appends the dict of per-step fields.
    """
    ws = kwargs.pop("ws", None)
    wd = kwargs.pop("wd", None)
    thc = kwargs.pop("thc", None)
    meta = kwargs.pop("meta", None)
    # None = the kernels on CUDA; False = the plain torch path, for holding
    # the kernels against it on the card.
    use_kernels = kwargs.pop("use_kernels", None)
    full_output = kwargs.pop("full_output", False)
    mesh = kwargs.pop("mesh", None)
    device = kwargs.pop("device", "cuda")
    if meta is None:
        u, v, t, ci = args
    else:
        u, v, t = meta.u, meta.v, meta.theta
        ci = getattr(meta, "ci", None)

    params = Params(**{k: kwargs.pop(k) for k in _PARAM_KEYS if k in kwargs})
    if kwargs:
        raise TypeError(f"unknown keyword arguments: {sorted(kwargs)}")
    device = torch.device(device)
    if mesh is not None:
        from .parallel.mesh import ShardMesh, make_mesh
        if not isinstance(mesh, ShardMesh):
            mesh = make_mesh(mesh, device=device)

    tt = max(1, int(tt))
    shape = np.asarray(lsm).shape
    for name, val in (("Windspeed", ws), ("Wind direction", wd),
                      ("Heating contrast", thc)):
        if val is None and tt > 1:
            # __init__.py:204-215 — state should be threaded between calls.
            warnings.warn(f"{name} should be given from previous timestep")
    zeros = np.zeros(shape, np.float32)
    state = TriggerState(
        tt=tt, thc=thc if thc is not None else zeros,
        windspeed=ws if ws is not None else zeros,
        winddir=wd if wd is not None else zeros)

    lon_a = np.asarray(lon, np.float32)
    lat_a = np.asarray(lat, np.float32)
    grid = Grid(lon=lon_a, lat=lat_a)
    base_key = (lon_a.tobytes(), lat_a.tobytes(), params, str(device),
                use_kernels)
    pipe = _cached_pipeline(base_key + ("base",), lambda: TriggerPipeline(
        grid=grid, params=params, device=device, use_kernels=use_kernels))

    single = len(tuple(v.shape)) <= 3

    def _tshape(s):
        return ((1,) + tuple(s)) if single else tuple(s)

    u_sh, v_sh, t_sh = _tshape(u.shape), _tshape(v.shape), _tshape(t.shape)
    ci_sh = None if ci is None else _tshape(np.shape(ci))
    T = u_sh[0]

    nlat, nlon = len(lat_a), len(lon_a)
    nlev = len(np.asarray(pres))
    problems = []
    for name, got, want in (("lsm", np.shape(lsm), (nlat, nlon)),
                            ("z", np.shape(z), (nlat, nlon)),
                            ("std", np.shape(std), (nlat, nlon)),
                            ("u", u_sh, (T, nlev, nlat, nlon)),
                            ("v", v_sh, (T, nlev, nlat, nlon)),
                            ("theta", t_sh, (T, nlat, nlon))):
        if tuple(got) != want:
            problems.append(f"{name}: got {tuple(got)}, want {want}")
    if ci_sh is not None and ci_sh != (T, nlat, nlon):
        problems.append(f"ci: got {ci_sh}, want {(T, nlat, nlon)}")
    pres_arr = np.asarray(pres)
    if pres_arr.ndim == 3 and pres_arr.shape != (nlev, nlat, nlon):
        problems.append(f"pres: got {pres_arr.shape}, want "
                        f"{(nlev, nlat, nlon)} (or 1-D (nlev,))")
    if problems:
        raise ValueError(
            "diag input shapes inconsistent with (lon, lat, pres) — "
            + "; ".join(problems))

    u = np.asarray(u[...], np.float32)
    v = np.asarray(v[...], np.float32)
    t = np.asarray(t[...], np.float32)
    ci = _fill(None if ci is None else ci[...])
    if single:
        u, v, t = u[None], v[None], t[None]
        if ci is not None:
            ci = ci[None]

    # Ring-search bound from the first step's distance field, measured on
    # the host (exact for any grid).  Sticky per grid: a bound >= the one
    # needed is reused, since wider rings change nothing once both classes
    # have latched.
    lsm_d = torch.as_tensor(np.asarray(lsm, np.float32), device=device)
    ci0 = None if ci is None else torch.as_tensor(ci[0], device=device)
    cdist0 = pipe.distance_field(lsm_d, ci0).cpu().numpy()
    needed = max(pipe.nn_max,
                 ring_radius(cdist0, params, pipe.k)
                 + params.ring_search_margin)
    nn_key = base_key + ("ring_nn",)
    prev_nn = _CACHE.get(nn_key)
    ring_nn = prev_nn if prev_nn is not None and prev_nn >= needed \
        else int(needed)
    _cache_put(nn_key, ring_nn)
    pipe = _cached_pipeline(base_key + ("ring", ring_nn), lambda:
                            TriggerPipeline(grid=grid, params=params,
                                            ring_nn=ring_nn, device=device,
                                            use_kernels=use_kernels))

    if mesh is not None:
        from .parallel.sharded import ShardedPipeline
        run_pipe = pipe
        pipe = _cached_pipeline(
            base_key + ("sharded", ring_nn, mesh.shape, str(mesh.device)),
            lambda: ShardedPipeline(run_pipe, mesh))
    final, outs = pipe.run(state, t, u, v, lsm_d, z, std, pres, ci_t=ci)
    _, thc_o, ws_o, wd_o = final.to_numpy()
    ret = (tt + T, outs["sb_con"].cpu().numpy(), thc_o, ws_o, wd_o)
    if full_output:
        return ret + ({k: o.cpu().numpy() for k, o in outs.items()},)
    return ret
