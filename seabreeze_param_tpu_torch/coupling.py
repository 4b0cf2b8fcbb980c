"""In-model coupling API, the UM-variant contract; counterpart of
``seabreeze_param_tpu.coupling``.

The reference's UM vn10.7 integration (``UM/vn10.7/sea_breeze_diag.F90``)
is how a host model calls the trigger from inside its physics suite:

  * 3-D pressure on rho levels; the target wind level is found per column
    (``UM/...F90:79-82, 265-274``);
  * the ``mask`` argument is the precomputed signed coast distance
    (``UM/...F90:96-98``), from ``get_edges``/``get_dist`` earlier in the
    step (``generic/dummy_model.f90:27-37``);
  * an integer ``error`` out-argument with a grid-bounds check
    (``UM/...F90:102, 196-202``);
  * DrHook enter/exit tracing around the routine (``UM/...F90:172, 324``),
    here :mod:`utils.tracing`.

:class:`CoupledTrigger` gives that contract on the card: its
:meth:`~CoupledTrigger.prepare_mask` runs the distance transform (kernel
B2), its :meth:`~CoupledTrigger.physics` one trigger step through kernel B4.
:func:`sea_breeze_diag` is the argument-for-argument functional form;
:func:`cumulus_mask` the boolean trigger mask a mass-flux convection scheme
would read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.params import MISSING_VALUE, Params
from .core.state import TriggerState
from .models.pipeline import TriggerPipeline, _f32
from .ops.coastline import get_edges
from .ops.trigger import trigger_step
from .utils.tracing import tracer as _default_tracer

#: UM error codes (UM/vn10.7/sea_breeze_diag.F90:102,196-202).
ERROR_NONE = 0
ERROR_BAD_GRID = 1


def _shape(a):
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


def validate_grid(nlats: int, nlons: int, nlev: int) -> int:
    """The UM bounds check (``UM/...F90:196-202``): error 1 on an empty
    horizontal grid or vertical axis."""
    if nlats < 1 or nlons < 1 or nlev < 1:
        return ERROR_BAD_GRID
    return ERROR_NONE


@dataclasses.dataclass(frozen=True)
class CoupledTrigger:
    """The trigger as an in-model physics routine.

    Bind once per model configuration; call :meth:`prepare_mask` when the
    land/ice mask changes (per step with moving sea ice, once otherwise —
    the coupling cadence of ``generic/dummy_model.f90:11-20``) and
    :meth:`physics` inside the physics suite.  ``use_kernels`` and
    ``device`` as in :class:`models.pipeline.TriggerPipeline`; ``nn_max``
    the ring-search bound (default: the provable k+2+margin); ``tracer`` a
    :class:`utils.tracing.Tracer` (default: the process-global one).
    """

    grid: object                     # core.grid.Grid
    params: Params = dataclasses.field(default_factory=Params)
    use_kernels: bool | None = None
    nn_max: int | None = None
    tracer: object = None
    device: str | torch.device = "cuda"

    def _tracer(self):
        return self.tracer if self.tracer is not None else _default_tracer

    def pipeline(self) -> TriggerPipeline:
        """The bound pipeline, built once: it holds the kernel choice and
        the device distance tables (built at the first
        :meth:`prepare_mask`)."""
        pipe = getattr(self, "_pipe", None)
        if pipe is None:
            pipe = TriggerPipeline(self.grid, self.params, device=self.device,
                                   use_kernels=self.use_kernels)
            object.__setattr__(self, "_pipe", pipe)
        return pipe

    # ------------------------------------------------------------------
    def prepare_mask(self, land_frac, ice_frac=None):
        """Coastline + signed coast distance, the pre-physics half of the
        coupling sequence (``dummy_model.f90:32-33``).  Returns cdist on
        the device, the UM routine's ``mask`` argument."""
        pipe = self.pipeline()
        dev = torch.device(self.device)
        tracer = self._tracer()
        lsm = _f32(land_frac, dev, tracer)
        ci = None if ice_frac is None else _f32(ice_frac, dev, tracer)
        with tracer.hook("coupling:get_edges"):
            coast = get_edges(lsm, ci,
                              exact_lon=self.params.exact_lon_indexing)
        with tracer.hook("coupling:get_dist"):
            return pipe.distance_from_coast(coast, lsm)

    # ------------------------------------------------------------------
    def physics(self, state: TriggerState, p, u, v, theta, z, sigma, mask):
        """The ``seabreeze_diag`` physics call (``UM/...F90:55-326``).

        p : (nlev,) or (nlev, nlat, nlon) pressure — 3-D selects the wind
            level per column.
        mask : signed coast distance from :meth:`prepare_mask`.

        Fields as arrays or tensors; ``state`` is not modified.  Returns
        ``(new_state, outputs)`` like ``TriggerPipeline.step``.
        """
        tracer = self._tracer()
        with tracer.hook("coupling:seabreeze_diag"):
            pipe = self.pipeline()
            dev = torch.device(self.device)
            p, u, v, theta, z, sigma, mask, thc, ws, wd = (
                _f32(a, dev, tracer) for a in (
                    p, u, v, theta, z, sigma, mask, state.thc,
                    state.windspeed, state.winddir))
            state = TriggerState(tt=int(state.tt), thc=thc, windspeed=ws,
                                 winddir=wd)
            nn = pipe.nn_max if self.nn_max is None else self.nn_max
            return trigger_step(state, theta, u, v, mask, z, sigma, p,
                                self.params, nn, use_kernels=pipe.kernels)


def sea_breeze_diag(timestep, timestep_number, p, u, v, theta, z, sigma,
                    mask, windspeed, winddir, thc, grid, *,
                    params: Params | None = None,
                    use_kernels: bool | None = None, device="cuda"):
    """Argument-for-argument functional form of the UM routine
    (``UM/vn10.7/sea_breeze_diag.F90:55-56``).

    Returns ``(sb_con, windspeed, winddir, thc, error)``: the inout fields
    updated, plus the UM error code; on a bad grid the inout fields come
    back untouched.  ``timestep`` is in seconds (the UM convention,
    ``UM/...F90:83``); the bound :class:`Params` carries it in minutes.

    Each call binds a fresh :class:`CoupledTrigger`, which costs nothing
    that lasts: the physics step needs no distance tables (the mask comes
    precomputed), and the kernel library is built and loaded once per
    process.
    """
    nlev = _shape(p)[0]
    nlats, nlons = _shape(theta)
    error = validate_grid(nlats, nlons, nlev)
    if error != ERROR_NONE:
        return (torch.zeros((), dtype=torch.float32), windspeed, winddir,
                thc, error)

    params = (params or Params()).replace(timestep=float(timestep) / 60.0)
    ct = CoupledTrigger(grid=grid, params=params, use_kernels=use_kernels,
                        device=device)
    state = TriggerState(tt=int(timestep_number), thc=thc,
                         windspeed=windspeed, winddir=winddir)
    new_state, out = ct.physics(state, p, u, v, theta, z, sigma, mask)
    return (out["sb_con"], new_state.windspeed, new_state.winddir,
            new_state.thc, ERROR_NONE)


def cumulus_mask(sb_con, *, min_strength: float = 0.0):
    """Mock downstream consumer: the boolean trigger mask a mass-flux
    cumulus scheme would read — sb_con above ``min_strength`` at valid
    cells, missing-value cells excluded."""
    sb = _f32(sb_con, None)
    valid = sb.abs() < float(MISSING_VALUE) / 2
    return valid & (sb > float(np.float32(min_strength)))
