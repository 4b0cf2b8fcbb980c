"""Drop-in public API mirroring ``seabreezediag.diag``; counterpart of
``seabreeze_param_tpu.api``.

    tt, sb_con, thc, ws, wd = diag(tt, lsm, z, std, lon, lat, pres,
                                   u, v, t, ci, **kwargs)

Same positional order, keyword names and defaults, returns, state threading
and warnings as the reference (``python_wrapper/seabreezediag/
__init__.py:91-263``), on top of :class:`models.pipeline.TriggerPipeline`.
Extensions: ``device``, ``use_kernels``, ``full_output`` and ``mesh`` —
the decomposed run (:class:`parallel.sharded.ShardedPipeline`): ``None``
(default, no decomposition, one device), ``'auto'`` (a near-square mesh,
one shard per device, as the JAX package's "2-D mesh over all local
devices"), ``'PYxPX'``, a ``(py, px)`` tuple or a
:class:`parallel.mesh.ShardMesh`.  ``device`` — None (default): the
current card, and for a mesh every visible card; one device: the run and
every shard there; a list: a mesh over those devices, one group of shards
per entry (``parallel.mesh.make_mesh``), the single-device parts of the
call on the first.  Returns host float32 arrays; ``thc`` is, as in the
reference, the sea-level temperature t0.

In a multi-process launch (a process group of more than one rank,
``parallel.distributed.initialize``) every call runs the decomposed run
over all processes, as the JAX package's does: ``mesh`` then fixes only
the global mesh shape (default ``(world, 1)``, or over a device list of
``n`` entries ``(world * py, n // py)``, ``parallel.distributed.
multihost_shape``), each process's block lies over its ``device`` (one
device, or a list: one group of shards per entry), each process reads
only its own rows of lazy netCDF handles, and every process returns the
global fields, gathered over the process group.
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
#: decomposed run the mesh shape and devices), and the
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


def needed_ring_nn(pipe: TriggerPipeline, cdist0) -> int:
    """The ring radius NN ``diag`` needs on ``pipe``'s grid: its static
    bound, or the radius probed on the first step's distance field
    ``cdist0`` (host array) plus the margin, whichever is larger."""
    params = pipe.params
    return int(max(pipe.nn_max, ring_radius(cdist0, params, pipe.k)
                   + params.ring_search_margin))


def _run_multihost(pipe, mesh, devices, key, state, t, u, v, lsm, z, std,
                   pres, ci, single):
    """The multi-process run (the reference's decomposed MPI run,
    ``UM/vn10.7/sea_breeze_diag.F90:408-410``): a
    :class:`parallel.distributed.DistributedRunner` over this process's
    block of the global mesh, laid over ``devices`` (a list: one group of
    shards per entry; else the pipeline's device), fed this process's rows
    only (``t``, ``u``, ``v`` and ``ci`` may be lazy netCDF handles, read
    over those rows), its outputs gathered back to the global grid on every
    process."""
    from .parallel import distributed as pdist
    from .parallel.mesh import ShardMesh, parse_shape
    from .parallel.sharded import ShardedPipeline
    shape = (mesh.global_shape if isinstance(mesh, ShardMesh)
             else parse_shape(mesh))
    devices = (list(devices) if isinstance(devices, (list, tuple))
               else [pipe.device])
    runner = _cached_pipeline(
        key + ("multihost", pdist.world_size(), shape,
               tuple(map(str, devices))),
        lambda: pdist.DistributedRunner(ShardedPipeline(
            pipe, pdist.make_multihost_mesh(shape, device=devices))))
    lo, hi = runner.row_lo, min(runner.row_hi, runner.sp.nlat_real)

    def slab(a, lead_t=False):
        """This process's rows of a field, read from disk for a lazy
        handle; ``lead_t`` adds the time axis of a single-step input."""
        nd = len(np.shape(a))
        x = a[(slice(None),) * (nd - 2) + (slice(lo, hi), slice(None))]
        x = np.asarray(x.filled(0) if hasattr(x, "filled") else x,
                       np.float32)
        return x[None] if lead_t and single else x

    final, outs = runner.run(
        TriggerState(state.tt, slab(state.thc), slab(state.windspeed),
                     slab(state.winddir)),
        slab(t, True), slab(u, True), slab(v, True), slab(lsm), slab(z),
        slab(std), slab(pres) if np.ndim(pres) == 3 else pres,
        ci_t=None if ci is None else slab(ci, True))
    span, nlat = runner.row_hi - runner.row_lo, runner.sp.nlat_real
    final = TriggerState(final.tt, *(
        pdist.gather_rows(getattr(final, f), span, nlat)
        for f in ("thc", "windspeed", "winddir")))
    return final, {k: pdist.gather_rows(o, span, nlat)
                   for k, o in outs.items()}


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
    device = kwargs.pop("device", None)
    if meta is None:
        u, v, t, ci = args
    else:
        u, v, t = meta.u, meta.v, meta.theta
        ci = getattr(meta, "ci", None)

    params = Params(**{k: kwargs.pop(k) for k in _PARAM_KEYS if k in kwargs})
    if kwargs:
        raise TypeError(f"unknown keyword arguments: {sorted(kwargs)}")
    # the mesh's devices: every card (None), a list, or the one device
    mesh_devices = device
    if isinstance(device, (list, tuple)):
        device = device[0]
    device = torch.device("cuda" if device is None else device)
    from .parallel.distributed import world_size
    multihost = world_size() > 1
    if mesh is not None and not multihost:
        from .parallel.mesh import ShardMesh, make_mesh
        if not isinstance(mesh, ShardMesh):
            mesh = make_mesh(mesh, device=mesh_devices)

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

    # Ring-search bound from the first step's distance field, measured on
    # the host (exact for any grid; every process of a multi-process run
    # measures the same global field).  Sticky per grid: a bound >= the
    # one needed is reused, since wider rings change nothing once both
    # classes have latched.
    lsm_d = torch.as_tensor(np.asarray(lsm, np.float32), device=device)
    ci0 = None if ci is None else torch.as_tensor(
        _fill(ci[...] if single else ci[0]), device=device)
    cdist0 = pipe.distance_field(lsm_d, ci0).cpu().numpy()
    needed = needed_ring_nn(pipe, cdist0)
    nn_key = base_key + ("ring_nn",)
    prev_nn = _CACHE.get(nn_key)
    ring_nn = prev_nn if prev_nn is not None and prev_nn >= needed \
        else int(needed)
    _cache_put(nn_key, ring_nn)
    pipe = _cached_pipeline(base_key + ("ring", ring_nn), lambda:
                            TriggerPipeline(grid=grid, params=params,
                                            ring_nn=ring_nn, device=device,
                                            use_kernels=use_kernels))

    if multihost:
        final, outs = _run_multihost(pipe, mesh, mesh_devices,
                                     base_key + (ring_nn,), state, t, u, v,
                                     lsm, z, std, pres, ci, single)
    else:
        u = np.asarray(u[...], np.float32)
        v = np.asarray(v[...], np.float32)
        t = np.asarray(t[...], np.float32)
        ci = _fill(None if ci is None else ci[...])
        if single:
            u, v, t = u[None], v[None], t[None]
            if ci is not None:
                ci = ci[None]
        if mesh is not None:
            from .parallel.sharded import ShardedPipeline
            run_pipe = pipe
            pipe = _cached_pipeline(
                base_key + ("sharded", ring_nn, mesh.shape, mesh.devices),
                lambda: ShardedPipeline(run_pipe, mesh))
        final, outs = pipe.run(state, t, u, v, lsm_d, z, std, pres, ci_t=ci)
    _, thc_o, ws_o, wd_o = final.to_numpy()
    ret = (tt + T, outs["sb_con"].cpu().numpy(), thc_o, ws_o, wd_o)
    if full_output:
        return ret + ({k: o.cpu().numpy() for k, o in outs.items()},)
    return ret
