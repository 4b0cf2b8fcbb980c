"""The full trigger pipeline: mask -> coastline -> distance -> trigger.

Counterpart of ``seabreeze_param_tpu.models.pipeline``: per step, rebuild
the coastline and coast distance from the (moving) sea-ice field, run the
trigger, and thread the state forward (reference ``__init__.py:219-245``).
The JAX ``lax.scan`` becomes a Python loop over T that enqueues device work
without waiting for it.  With the kernels (the default on CUDA), each step
of :meth:`TriggerPipeline.run` launches kernel B3 (or B2, with
``distance_impl='hybrid'``) for the distance and kernel B1 for the ring
search and trigger, which writes slot t of preallocated (T, nlat, nlon)
stacks; with ``use_kernels=False`` the plain torch ops run instead and their
fields are copied into the same stacks.  :meth:`TriggerPipeline.step`, the
single step a coupled model calls, takes kernel B4 for the ring search.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.grid import Grid
from ..core.params import Params
from ..core.state import TriggerState
from ..ops.coastline import get_edges
from ..ops.distance import coast_distance, device_tables, effective_radius
from ..ops.orography import sigmoid_weight
from ..ops.ring_search import static_ring_bound
from ..ops.trigger import trigger_step, trigger_step_stacked
from ..staging import Stager
from ..utils.tracing import tracer as _default_tracer


def _f32(a, device, tracer=None):
    """A float32 tensor on ``device`` (None: where ``a`` already is).  Host
    arrays become native float32 first: classic netCDF read through scipy
    is big-endian (``>f4``), which ``torch.as_tensor`` refuses.

    The port's moves of host fields and state to its device go through
    here, and each adds its float32 bytes to the counter ``h2d_bytes`` of
    ``tracer`` (default: the process-global one): a host array taken onto
    ``device`` (onto a CPU device too, where it is taken in place, so that
    the CPU counts what the card moves), or a CPU tensor moved to another
    device.  A tensor already on ``device``, or ``device`` None, counts 0."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float32)
        moved = device is not None
    else:
        moved = (device is not None and a.device.type == "cpu"
                 and torch.device(device).type != "cpu")
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    if moved:
        (tracer or _default_tracer).count("h2d_bytes", t.numel() * 4)
    return t


@dataclass(frozen=True)
class TriggerPipeline:
    """Bound pipeline over static fields (the reference ``diag``'s lsm, z,
    std, lon, lat, pres).

    ``device`` — where every tensor lives; the card by default.
    ``use_kernels`` — None: the kernel path on CUDA, the plain torch path
    on the CPU; True: the kernel path (whose wrappers take their plain
    versions for CPU tensors); False: the plain path, which exists to
    compare the kernels with it on the card.
    ``distance_impl`` — the coast-distance gather-min
    (``ops.distance.coast_distance``): ``'auto'`` (B3 on the card, B2 with
    the nearest lon form), ``'hybrid'`` (B2), ``'fused'`` (B3) or
    ``'plain'``, or the JAX package's ``'xla'``/``'pallas'``;
    ``use_kernels=False`` makes it ``'plain'``.
    ``distance_lon_form`` — pass 1's lon form: ``'taps'`` (exact) or
    ``'nearest'`` (a uniform global lon axis only, allclose to the taps;
    ``ops.distance.pass1_extrema_nearest``).
    """

    grid: Grid
    params: Params = field(default_factory=Params)
    device: str | torch.device = "cuda"
    use_kernels: bool | None = None
    distance_impl: str = "auto"
    distance_lon_form: str = "taps"

    @property
    def k(self) -> int:
        return effective_radius(self.grid, self.params.maxdist)

    @property
    def nn_max(self) -> int:
        """The static ring-search bound (:func:`ops.ring_search.
        static_ring_bound`), the NN of a run or step given none."""
        return static_ring_bound(self.k, self.params)

    @property
    def kernels(self) -> bool:
        """Whether :meth:`run` takes the stacked kernel path."""
        if self.use_kernels is None:
            return torch.device(self.device).type == "cuda"
        return bool(self.use_kernels)

    def _tables(self):
        tabs = getattr(self, "_tabs", None)
        if tabs is None:
            tabs = device_tables(self.grid, self.k, self.device)
            object.__setattr__(self, "_tabs", tabs)
        return tabs

    def stager(self):
        """The host staging slots and copy stream of ``api.diag``'s moves
        to this pipeline's device (:class:`staging.Stager`), built at
        first use and held with the pipeline."""
        st = getattr(self, "_stager", None)
        if st is None:
            st = Stager(self.device, (len(self.grid.lat), len(self.grid.lon)))
            object.__setattr__(self, "_stager", st)
        return st

    def distance_from_coast(self, coast, lsm):
        """Signed coast distance from a coastline field, through the
        pipeline's cached tables, its ``distance_impl`` and its
        ``distance_lon_form``."""
        impl = "plain" if self.use_kernels is False else self.distance_impl
        return coast_distance(coast, lsm, self.grid, self.params.maxdist,
                              k=self.k, tables=self._tables(), impl=impl,
                              lon_form=self.distance_lon_form)

    @_default_tracer.span("pipeline:distance")
    def distance_field(self, lsm, ci=None):
        """Coastline + signed coast distance for one (lsm, sea-ice) pair of
        float32 tensors on the pipeline's device."""
        coast = get_edges(lsm, ci, exact_lon=self.params.exact_lon_indexing)
        return self.distance_from_coast(coast, lsm)

    @_default_tracer.span("pipeline:step")
    def step(self, state: TriggerState, theta, u, v, lsm, z, std, pres,
             ci=None, smod=None, *, nn=None):
        """One full timestep (distance rebuild + trigger), kernel B4 on the
        kernel path, at ring radius ``nn`` (None: :attr:`nn_max`).  Fields
        as arrays or tensors (moved to the pipeline's device as float32);
        ``state`` holds tensors on that device and is not modified.
        Returns ``(new_state, outputs)``, outputs the four (nlat, nlon)
        fields of :func:`ops.trigger.trigger_core`."""
        dev = torch.device(self.device)
        theta, u, v, lsm, z, std, pres = (
            _f32(a, dev) for a in (theta, u, v, lsm, z, std, pres))
        cdist = self.distance_field(lsm, None if ci is None else _f32(ci, dev))
        return trigger_step(state, theta, u, v, cdist, z, std, pres,
                            self.params, self.nn_max if nn is None else nn,
                            smod=smod, use_kernels=self.kernels)

    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None, *, nn=None, feed=None):
        """Loop over the leading time axis at ring radius ``nn`` (None:
        :attr:`nn_max`; ``ops.ring_search.ring_bound`` gives the one a run
        needs).

        theta_t : (T, nlat, nlon); u_t, v_t : (T, nlev, nlat, nlon);
        ci_t : (T, nlat, nlon) or None (then the distance field is computed
        once, the reference's ci=None branch).  Arrays or tensors; they are
        moved to the pipeline's device as float32.  ``state`` is not
        modified.  ``feed`` — the staged moves of ``api.diag``
        (``staging.Stager.steps``), whose device stacks the time-varying
        inputs are: ``feed.ready(t)`` before step t, ``feed.done(t,
        sb_con[t])`` once step t is enqueued (slot t of the stacks is final
        then).

        Returns ``(final_state, outputs)``, outputs a dict of (T, nlat,
        nlon) tensors ``sb_con``, ``t0``, ``windspeed``, ``winddir``.
        """
        dev = torch.device(self.device)
        with _default_tracer.hook("pipeline:inputs"):
            lsm, z, std, pres = (_f32(a, dev) for a in (lsm, z, std, pres))
            theta_t, u_t, v_t = (_f32(a, dev) for a in (theta_t, u_t, v_t))
            ci_t = None if ci_t is None else _f32(ci_t, dev)
            st = TriggerState(tt=int(state.tt), thc=_f32(state.thc, dev),
                              windspeed=_f32(state.windspeed, dev).clone(),
                              winddir=_f32(state.winddir, dev).clone())
        T, nlat, nlon = theta_t.shape
        params, NN = self.params, self.nn_max if nn is None else nn

        smod = sigmoid_weight(std)
        cdist = None if ci_t is not None else self.distance_field(lsm)
        t0s = torch.empty((T, nlat, nlon), dtype=torch.float32, device=dev)

        if self.kernels:
            from ..ops.cuda.ring_kernel import StackedScan
            scan = StackedScan(nlat, nlon, params, dev)
            sb_b, ws_b, wd_b = scan.init_buffers(T, st.windspeed,
                                                 st.winddir)
        else:
            sb_b, ws_b, wd_b = (torch.empty_like(t0s) for _ in range(3))

        for t in range(T):
            with _default_tracer.hook("pipeline:step"):
                if feed is not None:
                    feed.ready(t)
                if ci_t is not None:
                    cdist = self.distance_field(lsm, ci_t[t])
                step = (theta_t[t], u_t[t], v_t[t], cdist, z, std, pres,
                        params, NN)
                if self.kernels:
                    st, t0s[t] = trigger_step_stacked(
                        st, *step, t, sb_b, ws_b, wd_b,
                        scan.add_coastal(cdist), smod=smod)
                else:
                    st, out = trigger_step(st, *step, smod=smod,
                                           use_kernels=False)
                    sb_b[t], t0s[t] = out["sb_con"], out["t0"]
                    ws_b[t], wd_b[t] = out["windspeed"], out["winddir"]
                if feed is not None:
                    feed.done(t, sb_b[t])
        return st, {"sb_con": sb_b, "t0": t0s, "windspeed": ws_b,
                    "winddir": wd_b}
