"""The sea-breeze trigger core (reference ``diag``,
``seabreeze_diag_python.f90:49-285``); counterpart of
``seabreeze_param_tpu.ops.trigger``.

All arithmetic is float32 with the reference's constants (rad2deg =
57.2957, gmma = -0.0060956).  The wind-direction difference uses floor
modulo (``torch.remainder``, as ``jnp.mod``), never ``torch.fmod``.

Two forms of a timestep, each :func:`prepare_step` (t0, wind, pads) then a
per-cell core:

* :func:`trigger_step` / :func:`trigger_core` — per-step fields, through
  kernel B4 (``ops/cuda/ring_kernel.py``) or the plain torch path
  (:func:`trigger_cells`); ``TriggerPipeline.step``, the coupling API and
  the plain ``TriggerPipeline.run`` call it;
* :func:`trigger_step_stacked` / :func:`trigger_core_stacked` — the
  production scan: kernel B1 writes slot t of preallocated (T, h, w)
  stacks and updates the wind state in place.

A decomposed run (``parallel.sharded``) calls the cores per shard with the
shard's ``row_offset`` in the ``nlat_total``-row grid, which places the
reference's unwritten last row; its basic step exchanges the ring inputs
of all shards at once between :func:`prepare_step`'s parts and
:func:`trigger_core`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.params import GMMA, MISSING_VALUE, RAD2DEG_TRIGGER, Params
from ..core.state import TriggerState
from .indexing import pad2d
from .orography import sigmoid_weight
from .ring_search import ring_quantities, ring_thc_from_padded


def sea_level_temperature(theta, z, smod):
    """t0 = theta - gmma * z * smod (seabreeze_diag_python.f90:158)."""
    return theta - (float(GMMA) * z * smod)


def wind_at_level(u, v, pres, target_plev_pa):
    """Wind speed/direction at the level nearest the target pressure.

    ``pres`` is 1-D (nlev,) or 3-D (nlev, nlat, nlon); the nearest level is
    the first argmin of |p - target|, per column for 3-D pressure.  Speed =
    sqrt(u^2 + v^2); direction = atan2(-u, -v) * rad2deg.
    """
    dist = (pres - float(target_plev_pa)).abs()
    if pres.dim() == 1:
        p_lev = torch.argmin(dist).reshape(1)
        ul = u.index_select(0, p_lev)[0]
        vl = v.index_select(0, p_lev)[0]
    else:
        p_lev = torch.argmin(dist, dim=0, keepdim=True)
        ul = torch.gather(u, 0, p_lev)[0]
        vl = torch.gather(v, 0, p_lev)[0]
    speed = torch.sqrt(ul * ul + vl * vl)
    direction = torch.atan2(-ul, -vl) * float(RAD2DEG_TRIGGER)
    return speed, direction


def cadence(tt: int, params: Params):
    """(is_first, upd) for timestep ``tt``: first-step seeding, and the
    wind-state refresh every target_time hours, in float32 on the host
    exactly as the JAX package computes it."""
    upd = np.mod(np.float32(tt) * params.timestep_seconds,
                 params.target_time_seconds) < np.float32(1.0e-4)
    return tt < 2, bool(upd)


def row_mask(h: int, params: Params, device, row_offset: int = 0,
             nlat_total: int | None = None):
    """(h, 1) bool: rows the reference writes (``do i=1,nlats-1``) of a
    block whose first row is global row ``row_offset`` of an
    ``nlat_total``-row grid (default: the block is the grid).  Rows at or
    beyond ``nlat_total`` (a decomposed grid's lat padding) are out too,
    as in kernels B1 and B4."""
    nlat = h if nlat_total is None else nlat_total
    last = nlat - 1 if params.skip_last_lat_row else nlat
    return (torch.arange(row_offset, row_offset + h, device=device)
            < last)[:, None]


def trigger_cells(cdist, ws_new, wd_new, ws_state, wd_state, t0_pad, cd_pad,
                  is_first: bool, upd: bool, params: Params, nn_max: int, *,
                  row_offset: int = 0, nlat_total: int | None = None):
    """The plain version of kernels B1 and B4: ring THC and trigger tail
    for every cell.  Returns ``(sb, ws_out, wd_out, ws_state',
    wd_state')``: the three output fields of the step (zero in the
    reference's unwritten last row) and the new wind state (frozen in that
    row).  ``row_offset``/``nlat_total`` place the block in the global grid
    (:func:`row_mask`)."""
    coastal = cdist.abs() <= float(np.float32(params.maxdist))
    mul = torch.where(cdist >= 0.0, 1.0, -1.0)
    n_thc, _ = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad), mul,
                                    nn_max, coastal=coastal)

    # First-timestep seeding (seabreeze_diag_python.f90:236-240).
    seed = coastal if is_first else torch.zeros_like(coastal)
    ws_base = torch.where(seed, ws_new, ws_state)
    wd_base = torch.where(seed, wd_new, wd_state)

    f32 = np.float32
    thc_abs = n_thc.abs()
    mws = (ws_base + ws_new) / 2.0
    dws = (ws_base - ws_new).abs()
    dwd = (torch.remainder((wd_base - wd_new) + 180.0, 360.0) - 180.0).abs()
    cond = ((dwd < float(f32(params.thresh_winddir)))
            & (dws < float(f32(params.thresh_windch)))
            & (mws < float(f32(params.thresh_wind)))
            & (thc_abs > float(f32(params.thresh_thc))))
    scale_wind = (float(f32(params.thresh_wind)) - mws) / torch.clamp_min(
        mws, 1.0)
    thc_safe = torch.where(n_thc == 0.0, 1.0, n_thc)
    scale_thc = (thc_abs - float(f32(params.thresh_thc))) / thc_safe
    sb = torch.where(coastal, torch.where(cond, scale_thc * scale_wind, 0.0),
                     float(MISSING_VALUE))

    # Wind state refreshes only every target_time hours
    # (seabreeze_diag_python.f90:268-274).
    take = coastal & (is_first or upd)
    ws_o = torch.where(take, ws_new, ws_state)
    wd_o = torch.where(take, wd_new, wd_state)

    row_ok = row_mask(cdist.shape[0], params, cdist.device, row_offset,
                      nlat_total)
    return (torch.where(row_ok, sb, 0.0), torch.where(row_ok, ws_o, 0.0),
            torch.where(row_ok, wd_o, 0.0),
            torch.where(row_ok, ws_o, ws_state),
            torch.where(row_ok, wd_o, wd_state))


def trigger_core(state: TriggerState, t0, cdist, ws_new, wd_new, t0_pad,
                 cd_pad, params: Params, nn_max: int, *, row_offset: int = 0,
                 nlat_total: int | None = None,
                 use_kernels: bool | None = None):
    """The per-cell part of a timestep from pre-padded ring inputs.
    Returns ``(new_state, outputs)`` with outputs the four reference slots
    ``sb_con``, ``t0``, ``windspeed``, ``winddir``.  The threaded ``thc``
    slot carries t0 (reference convention).  ``state`` is not modified.
    ``row_offset``/``nlat_total`` place a shard's block in the global grid
    (:func:`row_mask`).

    ``use_kernels`` (the JAX package's ``use_pallas``) — None: kernel B4 for
    a CUDA tensor, the plain path for a CPU tensor; True: B4 through its
    wrapper; False: the plain path (:func:`trigger_cells`)."""
    is_first, upd = cadence(state.tt, params)
    row_ok = row_mask(t0.shape[0], params, t0.device, row_offset, nlat_total)
    if use_kernels is None:
        use_kernels = t0.device.type == "cuda"
    if use_kernels:
        from .cuda.ring_kernel import ring_trigger_cuda_padded
        # B4 returns the new state (frozen in the unwritten last row); the
        # output slots are zero there, as the plain path's.
        sb, ws_st, wd_st = ring_trigger_cuda_padded(
            t0_pad, cd_pad, cdist, ws_new, wd_new, state.windspeed,
            state.winddir, is_first, upd, params, nn_max,
            row_offset=row_offset, nlat_total=nlat_total)
        out_ws = torch.where(row_ok, ws_st, 0.0)
        out_wd = torch.where(row_ok, wd_st, 0.0)
    else:
        sb, out_ws, out_wd, ws_st, wd_st = trigger_cells(
            cdist, ws_new, wd_new, state.windspeed, state.winddir, t0_pad,
            cd_pad, is_first, upd, params, nn_max, row_offset=row_offset,
            nlat_total=nlat_total)
    out_t0 = torch.where(row_ok, t0, 0.0)
    new_state = TriggerState(tt=state.tt + 1, thc=out_t0, windspeed=ws_st,
                             winddir=wd_st)
    return new_state, {"sb_con": sb, "t0": out_t0, "windspeed": out_ws,
                       "winddir": out_wd}


def prepare_step(theta, u, v, cdist, z, std, pres, params: Params,
                 nn_max: int, smod=None):
    """t0, the wind at the target level and the NN-padded ring inputs."""
    if smod is None:
        smod = sigmoid_weight(std)
    t0 = sea_level_temperature(theta, z, smod)
    ws_new, wd_new = wind_at_level(u, v, pres, params.target_plev_pa)
    t0_pad = pad2d(t0, nn_max, nn_max, exact_lon=params.exact_lon_indexing)
    cd_pad = pad2d(cdist, nn_max, nn_max, exact_lon=params.exact_lon_indexing)
    return t0, ws_new, wd_new, t0_pad, cd_pad


def trigger_step(state: TriggerState, theta, u, v, cdist, z, std, pres,
                 params: Params, nn_max: int, *, smod=None,
                 use_kernels: bool | None = None):
    """One trigger timestep.  ``smod`` may be passed precomputed (it
    depends only on the static ``std``); ``use_kernels`` as in
    :func:`trigger_core`.  Returns ``(new_state, outputs)``."""
    t0, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        theta, u, v, cdist, z, std, pres, params, nn_max, smod)
    return trigger_core(state, t0, cdist, ws_new, wd_new, t0_pad, cd_pad,
                        params, nn_max, use_kernels=use_kernels)


def trigger_core_stacked(state: TriggerState, t0, cdist, ws_new, wd_new,
                         t0_pad, cd_pad, params: Params, nn_max: int,
                         step_idx: int, sb_buf, ws_buf, wd_buf, ever, *,
                         row_offset: int = 0, nlat_total: int | None = None):
    """:func:`trigger_core` through kernel B1: writes slot ``step_idx`` of
    the (T, h, w) stacks ``sb_buf``/``ws_buf``/``wd_buf`` and updates
    ``state.windspeed``/``state.winddir`` IN PLACE, visiting only the tiles
    set in ``ever`` (``ops.cuda.ring_kernel.StackedScan``).  Returns
    ``(new_state, out_t0)``; the new state shares the updated wind tensors.
    ``row_offset``/``nlat_total`` as in :func:`trigger_core`.
    """
    from .cuda.ring_kernel import ring_trigger_cuda_stacked

    is_first, upd = cadence(state.tt, params)
    ring_trigger_cuda_stacked(
        t0_pad, cd_pad, cdist, ws_new, wd_new, state.windspeed,
        state.winddir, is_first, upd, params, nn_max, step_idx, sb_buf,
        ws_buf, wd_buf, ever, row_offset=row_offset, nlat_total=nlat_total)
    out_t0 = torch.where(row_mask(t0.shape[0], params, t0.device, row_offset,
                                  nlat_total), t0, 0.0)
    new_state = TriggerState(tt=state.tt + 1, thc=out_t0,
                             windspeed=state.windspeed,
                             winddir=state.winddir)
    return new_state, out_t0


def trigger_step_stacked(state: TriggerState, theta, u, v, cdist, z, std,
                         pres, params: Params, nn_max: int, step_idx: int,
                         sb_buf, ws_buf, wd_buf, ever, *, smod=None):
    """One timestep of the production path: :func:`trigger_step` with its
    outputs written in place through kernel B1 (see
    :func:`trigger_core_stacked`).  Returns ``(new_state, out_t0)``."""
    t0, ws_new, wd_new, t0_pad, cd_pad = prepare_step(
        theta, u, v, cdist, z, std, pres, params, nn_max, smod)
    return trigger_core_stacked(state, t0, cdist, ws_new, wd_new, t0_pad,
                                cd_pad, params, nn_max, step_idx, sb_buf,
                                ws_buf, wd_buf, ever)
