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

With 1-D pressure the trigger reads u and v at one level, the same for
every cell and step: ``diag`` picks it on the host
(:func:`ops.trigger.nearest_level`, the device's own rule) and reads and
moves only that level, with ``pres`` at it.  With 3-D pressure the level
is picked per column, and every level moves.

Each call runs at the ring radius NN that :func:`ops.ring_search.
ring_bound` gives on its first step's distance field: the static bound
k + 2 + margin, or the probed radius plus the margin, whichever is larger.

A call in one process, with no mesh, on host arrays and not with
``use_kernels=False`` moves its arrays through the grid's
:class:`staging.Stager`, held with its cached pipeline: each step's inputs
go up while the step before it runs, and each step's ``sb_con`` comes back
as soon as its step has run (on a CUDA device through pinned slots on a
copy stream, the host's copies on two worker threads).  Every other call
moves them as ``models.pipeline._f32`` and ``.cpu()`` do.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .core.grid import Grid
from .core.params import Params
from .core.state import TriggerState
from .models.pipeline import TriggerPipeline, _f32
from .ops.ring_search import ring_bound
from .ops.trigger import nearest_level
from .utils.tracing import tracer

_PARAM_KEYS = ("target_plev", "thresh_wind", "thresh_winddir",
               "thresh_windch", "thresh_thc", "target_time", "timestep",
               "maxdist")

#: Pipelines keyed by (grid, params, device, kernels, and for a decomposed
#: run the mesh shape and devices); least recently used entries go first.
#: A pipeline caches its device distance tables, so a batch run over many
#: files on one grid builds them once.
_CACHE: OrderedDict = OrderedDict()
_CACHE_MAX = 16
CACHE_STATS = {"pipeline_hits": 0, "pipeline_misses": 0}


def clear_exec_cache():
    """Drop all cached pipelines."""
    _CACHE.clear()
    CACHE_STATS["pipeline_hits"] = 0
    CACHE_STATS["pipeline_misses"] = 0


def _cached_pipeline(key, build):
    pipe = _CACHE.get(key)
    if pipe is None:
        CACHE_STATS["pipeline_misses"] += 1
        pipe = build()
    else:
        CACHE_STATS["pipeline_hits"] += 1
    _CACHE[key] = pipe
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return pipe


def _fill(ci):
    """``ci.filled(0)`` for masked arrays (__init__.py:225), else as-is, in
    its own dtype (the moves cast to float32)."""
    if ci is None:
        return None
    if hasattr(ci, "filled"):
        return np.asarray(ci.filled(0))
    return np.asarray(ci)


def _on_host(a):
    return not isinstance(a, torch.Tensor) or a.device.type == "cpu"


def _run_multihost(pipe, mesh, devices, key, state, t, u, v, lsm, z, std,
                   pres, ci, single, lev, nn):
    """The multi-process run (the reference's decomposed MPI run,
    ``UM/vn10.7/sea_breeze_diag.F90:408-410``): a
    :class:`parallel.distributed.DistributedRunner` over this process's
    block of the global mesh, laid over ``devices`` (a list: one group of
    shards per entry; else the pipeline's device), fed this process's rows
    only (``t``, ``u``, ``v`` and ``ci`` may be lazy netCDF handles, read
    over those rows; ``u`` and ``v`` at the one level ``lev`` unless it is
    None), its outputs gathered back to the global grid on every
    process; at ring radius ``nn``."""
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

    def slab(a, lead_t=False, level=None):
        """This process's rows of a field, read from disk for a lazy
        handle; ``lead_t`` adds the time axis of a single-step input;
        ``level`` takes that one level of u or v in the same indexing."""
        lead = (slice(None),) * (len(np.shape(a)) - 2)
        if level is not None:
            lead = lead[:-1] + (slice(level, level + 1),)
        x = a[lead + (slice(lo, hi), slice(None))]
        x = np.asarray(x.filled(0) if hasattr(x, "filled") else x,
                       np.float32)
        return x[None] if lead_t and single else x

    final, outs = runner.run(
        TriggerState(state.tt, slab(state.thc), slab(state.windspeed),
                     slab(state.winddir)),
        slab(t, True), slab(u, True, lev), slab(v, True, lev), slab(lsm),
        slab(z), slab(std), slab(pres) if np.ndim(pres) == 3 else pres,
        ci_t=None if ci is None else slab(ci, True), nn=nn)
    span, nlat = runner.row_hi - runner.row_lo, runner.sp.nlat_real
    final = TriggerState(final.tt, *(
        pdist.gather_rows(getattr(final, f), span, nlat)
        for f in ("thc", "windspeed", "winddir")))
    return final, {k: pdist.gather_rows(o, span, nlat)
                   for k, o in outs.items()}


def _run_staged(pipe, stager, state, t, u, v, lsm_d, z, std, pres, ci, nn,
                sb_con):
    """``pipe.run`` on host arrays moved through ``stager``: the static
    fields and the state once, and step by step one (P, nlat, nlon) slice
    of a device stack holding each step's theta, u and v at the levels
    read, and ci; each step's ``sb_con`` read back into ``sb_con``.  The
    state is read back by the caller."""
    T, L = u.shape[:2]
    planes = (t, u, v) if ci is None else (t, u, v, ci)
    stack = torch.empty((T, 1 + 2 * L + (ci is not None)) + t.shape[1:],
                        dtype=torch.float32, device=stager.device)
    state_d = TriggerState(state.tt, *(stager.upload(a) for a in (
        state.thc, state.windspeed, state.winddir)))
    z, std, pres = (stager.upload(a) for a in (z, std, pres))
    feed = stager.steps(lambda s: [a[s] for a in planes], stack, sb_con)
    return pipe.run(state_d, stack[:, 0], stack[:, 1:1 + L],
                    stack[:, 1 + L:1 + 2 * L], lsm_d, z, std, pres,
                    ci_t=None if ci is None else stack[:, -1], nn=nn,
                    feed=feed)


def _to_host(t, site: str):
    """A device tensor read back as a host float32 array, under the span
    ``wait:<site>``: the host waits here for the device."""
    with tracer.hook(f"wait:{site}"):
        return t.detach().cpu().numpy()


@tracer.span("api:diag")
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
    key = (lon_a.tobytes(), lat_a.tobytes(), params, str(device),
           use_kernels)
    pipe = _cached_pipeline(key, lambda: TriggerPipeline(
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
    # 1-D pressure: the one level the trigger reads, picked here by the
    # device's rule on the same float32 values, so the device, given that
    # level alone, picks it again; 3-D pressure: every level
    lev, levels = None, (Ellipsis,)
    if pres_arr.ndim == 1:
        pres = np.asarray(pres_arr, np.float32)
        lev = int(nearest_level(torch.tensor(pres), params.target_plev_pa))
        pres = pres[lev:lev + 1]
        levels = ((slice(lev, lev + 1),) if single
                  else (slice(None), slice(lev, lev + 1)))

    # one process, no decomposition, host arrays, the kernels' path: the
    # moves go through the grid's staging slots, overlapped with the steps
    stager = None
    if (not multihost and mesh is None and use_kernels is not False
            and all(map(_on_host, (lsm, z, std, state.thc, state.windspeed,
                                   state.winddir)))):
        stager = pipe.stager()

    def up(a):
        return _f32(a, device) if stager is None else stager.upload(a)

    # the ring radius from the first step's distance field, measured on
    # the device (every process of a multi-process run measures the same
    # global field)
    with tracer.hook("api:probe"):
        lsm_d = up(lsm)
        ci0 = None if ci is None else up(_fill(ci[...] if single else ci[0]))
        nn = ring_bound(pipe.distance_field(lsm_d, ci0), pipe.k, params)

    with tracer.hook("api:run"):
        if multihost:
            final, outs = _run_multihost(pipe, mesh, mesh_devices, key,
                                         state, t, u, v, lsm, z, std, pres,
                                         ci, single, lev, nn)
        else:
            # only these levels are read from a lazy handle and moved
            u, v = np.asarray(u[levels]), np.asarray(v[levels])
            t = np.asarray(t[...])
            ci = _fill(None if ci is None else ci[...])
            if single:
                u, v, t = u[None], v[None], t[None]
                if ci is not None:
                    ci = ci[None]
            if stager is not None:
                sb_con = np.empty((T, nlat, nlon), np.float32)
                final, outs = _run_staged(pipe, stager, state, t, u, v, lsm_d,
                                          z, std, pres, ci, nn, sb_con)
            else:
                u, v, t = (np.asarray(a, np.float32) for a in (u, v, t))
                if lev is not None:
                    # a step's level is contiguous where the whole slice
                    # is not: move the steps one by one, so the host
                    # gathers none
                    u, v = (torch.stack([_f32(x, device) for x in a])
                            for a in (u, v))
                if mesh is not None:
                    from .parallel.sharded import ShardedPipeline
                    run_pipe = pipe
                    pipe = _cached_pipeline(
                        key + ("sharded", mesh.shape, mesh.devices),
                        lambda: ShardedPipeline(run_pipe, mesh))
                final, outs = pipe.run(state, t, u, v, lsm_d, z, std, pres,
                                       ci_t=ci, nn=nn)
    with tracer.hook("api:outputs"):
        state_d = (final.thc, final.windspeed, final.winddir)
        if stager is None:
            thc_o, ws_o, wd_o = (_to_host(a, "state_readback")
                                 for a in state_d)
            ret = (tt + T, _to_host(outs["sb_con"], "output_readback"),
                   thc_o, ws_o, wd_o)
        else:
            ret = (tt + T, sb_con) + tuple(
                np.empty((nlat, nlon), np.float32) for _ in state_d)
            for a, o in zip(state_d, ret[2:]):
                stager.get(a, o, "state_readback")
            stager.finish()
        if full_output:
            return ret + ({k: _to_host(o, "output_readback")
                           for k, o in outs.items()},)
        return ret
