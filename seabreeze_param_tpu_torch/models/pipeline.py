"""The full trigger pipeline: mask -> coastline -> distance -> trigger.

Counterpart of ``seabreeze_param_tpu.models.pipeline``: per step, rebuild
the coastline and coast distance from the (moving) sea-ice field, run the
trigger, and thread the state forward (reference ``__init__.py:219-245``).
The JAX ``lax.scan`` becomes a Python loop over T that enqueues device work
without waiting for it.  With the kernels (the default on CUDA), each step
of :meth:`TriggerPipeline.run` launches kernel B2 (or B3, with
``distance_impl='fused'``) for the distance and kernel B1 for the ring
search and trigger, which writes slot t of preallocated (T, nlat, nlon)
stacks; with ``use_kernels=False`` the plain torch ops run instead and their
fields are copied into the same stacks.  :meth:`TriggerPipeline.step`, the
single step a coupled model calls, takes kernel B4 for the ring search.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.grid import Grid
from ..core.params import Params
from ..core.state import TriggerState
from ..ops.coastline import get_edges
from ..ops.distance import coast_distance, device_tables, effective_radius
from ..ops.orography import sigmoid_weight
from ..ops.trigger import trigger_step, trigger_step_stacked


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


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
    (``ops.distance.coast_distance``): ``'auto'`` (B2 on the card),
    ``'hybrid'``, ``'fused'`` (B3) or ``'plain'``; ``use_kernels=False``
    makes it ``'plain'``.
    """

    grid: Grid
    params: Params = field(default_factory=Params)
    ring_nn: int | None = None
    device: str | torch.device = "cuda"
    use_kernels: bool | None = None
    distance_impl: str = "auto"

    @property
    def k(self) -> int:
        return effective_radius(self.grid, self.params.maxdist)

    @property
    def nn_max(self) -> int:
        """Static ring-search bound: k+2 plus the margin on physically
        periodic grids, or the measured ``ring_nn``."""
        if self.ring_nn is not None:
            return max(1, int(self.ring_nn))
        return max(3, self.k + 2 + self.params.ring_search_margin)

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

    def distance_from_coast(self, coast, lsm):
        """Signed coast distance from a coastline field, through the
        pipeline's cached tables and its ``distance_impl``."""
        impl = "plain" if self.use_kernels is False else self.distance_impl
        return coast_distance(coast, lsm, self.grid, self.params.maxdist,
                              k=self.k, tables=self._tables(), impl=impl)

    def distance_field(self, lsm, ci=None):
        """Coastline + signed coast distance for one (lsm, sea-ice) pair of
        float32 tensors on the pipeline's device."""
        coast = get_edges(lsm, ci, exact_lon=self.params.exact_lon_indexing)
        return self.distance_from_coast(coast, lsm)

    def step(self, state: TriggerState, theta, u, v, lsm, z, std, pres,
             ci=None, smod=None):
        """One full timestep (distance rebuild + trigger), kernel B4 on the
        kernel path.  Fields as arrays or tensors (moved to the pipeline's
        device as float32); ``state`` holds tensors on that device and is
        not modified.  Returns ``(new_state, outputs)``, outputs the four
        (nlat, nlon) fields of :func:`ops.trigger.trigger_core`."""
        dev = torch.device(self.device)
        theta, u, v, lsm, z, std, pres = (
            _f32(a, dev) for a in (theta, u, v, lsm, z, std, pres))
        cdist = self.distance_field(lsm, None if ci is None else _f32(ci, dev))
        return trigger_step(state, theta, u, v, cdist, z, std, pres,
                            self.params, self.nn_max, smod=smod,
                            use_kernels=self.kernels)

    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None):
        """Loop over the leading time axis.

        theta_t : (T, nlat, nlon); u_t, v_t : (T, nlev, nlat, nlon);
        ci_t : (T, nlat, nlon) or None (then the distance field is computed
        once, the reference's ci=None branch).  Arrays or tensors; they are
        moved to the pipeline's device as float32.  ``state`` is not
        modified.

        Returns ``(final_state, outputs)``, outputs a dict of (T, nlat,
        nlon) tensors ``sb_con``, ``t0``, ``windspeed``, ``winddir``.
        """
        dev = torch.device(self.device)
        lsm, z, std, pres = (_f32(a, dev) for a in (lsm, z, std, pres))
        theta_t, u_t, v_t = (_f32(a, dev) for a in (theta_t, u_t, v_t))
        ci_t = None if ci_t is None else _f32(ci_t, dev)
        T, nlat, nlon = theta_t.shape
        params, NN = self.params, self.nn_max

        st = TriggerState(tt=int(state.tt), thc=_f32(state.thc, dev),
                          windspeed=_f32(state.windspeed, dev).clone(),
                          winddir=_f32(state.winddir, dev).clone())
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
            if ci_t is not None:
                cdist = self.distance_field(lsm, ci_t[t])
            step = (theta_t[t], u_t[t], v_t[t], cdist, z, std, pres, params,
                    NN)
            if self.kernels:
                st, t0s[t] = trigger_step_stacked(
                    st, *step, t, sb_b, ws_b, wd_b, scan.add_coastal(cdist),
                    smod=smod)
            else:
                st, out = trigger_step(st, *step, smod=smod,
                                       use_kernels=False)
                sb_b[t], t0s[t] = out["sb_con"], out["t0"]
                ws_b[t], wd_b[t] = out["windspeed"], out["winddir"]
        return st, {"sb_con": sb_b, "t0": t0s, "windspeed": ws_b,
                    "winddir": wd_b}
