"""The decomposed trigger pipeline over a shard mesh; counterpart of
``seabreeze_param_tpu.parallel.sharded``.

The JAX package runs the per-shard scan under ``shard_map``, one shard per
device, with ``ppermute`` exchanges (or its DMA kernel) between them.  Here
one process holds every shard of a :class:`parallel.mesh.ShardMesh` on one
device: each step runs the shards one after another, each on its own
launches, and every halo exchange serves all shards at once through
``parallel.halo`` — on the kernel path one launch of kernel B6.  The
sigmoid's global statistics are combined over the shard list
(``ops.orography.sigmoid_weight_shards``).

Two step structures, as in the JAX package:

**Overlapped.**  Two exchanges at the top of each step — the mask with an
(nn + k + 1)-wide apron, wide enough that the Sobel coastline, the k-wide
distance gather and the nn-wide ring inputs are computed on the apron
instead of exchanged, and theta with an nn-wide apron (t0 is elementwise
and the z / lsm / smod aprons are static, exchanged once per run).  The
exchanges start before the step's wind read and finish after it.  The
kernel path runs per shard kernel B2 (B3 with ``distance_impl='fused'``)
on the apron-extended block and kernel B1 through a per-shard
``StackedScan``.

**Basic.**  Three exchanges per step (mask 1-wide, coast k-wide with zero
lat fill, the ``[t0, cdist]`` ring inputs nn-wide in one launch), for
shards too small for the apron; kernels B2 and B4.  Unlike the JAX
package, whose DMA exchange served the basic structure only, the kernel
exchange here serves both.

Why the apron form is exact, and why edge-row replication padding of the
lat axis to a multiple of the mesh rows is (global statistics leave the
padding rows out through ``valid_mask``; outputs are sliced back to the
real rows): see the JAX module's docstring, which this port follows step
for step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import TriggerState
from ..models.pipeline import TriggerPipeline
from ..ops.coastline import make_mask, sobel_edges_from_padded
from ..ops.distance import coast_distance_from_padded, device_tables
from ..ops.orography import sigmoid_weight_shards
from ..ops.trigger import (sea_level_temperature, trigger_core,
                           trigger_core_stacked, trigger_step_shards,
                           wind_at_level)
from .halo import (halo_finish, halo_pad, halo_start, quirky_seam_patch,
                   resolve_backend)
from .mesh import ShardMesh, gather, split

OUT_KEYS = ("sb_con", "t0", "windspeed", "winddir")


def _pad_lat(t, nlat_pad: int):
    """Replicate the last lat row (dim -2) of a tensor up to nlat_pad."""
    nlat = t.shape[-2]
    if nlat == nlat_pad:
        return t
    idx = torch.arange(nlat_pad, device=t.device).clamp_(max=nlat - 1)
    return t.index_select(t.dim() - 2, idx)


@dataclasses.dataclass
class ShardedPipeline:
    """Decomposed version of :class:`models.pipeline.TriggerPipeline`.

    Requires nlon % px == 0; nlat is replication-padded to a multiple of
    py.  ``overlap`` — ``'auto'`` (default): the overlapped structure
    whenever the mask apron fits the shard, else basic; True/False force
    it.  ``halo_backend`` — ``'auto'`` (default): ``'kernel'`` (B6; its
    plain version for CPU tensors) unless the pipeline has
    ``use_kernels=False``, then ``'plain'``.  The JAX package's
    ``'ppermute'`` and ``'dma'`` are ``'plain'`` and ``'kernel'`` here.
    The shards live on ``mesh.device``, which must be the pipeline's.
    """

    pipeline: TriggerPipeline
    mesh: ShardMesh
    overlap: object = "auto"
    halo_backend: str = "auto"

    def __post_init__(self):
        pipe, mesh = self.pipeline, self.mesh
        grid = pipe.grid
        py, px = mesh.shape
        if torch.device(pipe.device).type != mesh.device.type:
            raise ValueError(f"pipeline on {pipe.device}, mesh on "
                             f"{mesh.device}")
        if grid.nlon % px:
            raise ValueError(f"nlon={grid.nlon} not divisible by mesh x={px}")
        self.nlat_real = grid.nlat
        self.nlat_pad = -(-grid.nlat // py) * py
        lat_idx = np.minimum(np.arange(self.nlat_pad), grid.nlat - 1)
        self.grid_padded = Grid(lon=grid.lon, lat=grid.lat[lat_idx])
        self.k, self.nn_max = pipe.k, pipe.nn_max
        self.kernels = pipe.kernels
        self.halo_backend = resolve_backend(self.halo_backend,
                                            pipe.use_kernels)
        self.distance_impl = ("plain" if pipe.use_kernels is False
                              else pipe.distance_impl)
        # Halo-width guard: every exchanged width must fit inside one
        # shard, in lon strictly when the quirky seam patches are on (at
        # hx == w the copy of global column nlon-1 in a neighbour's
        # opposite halo has no patch position).
        self.h, self.w = self.nlat_pad // py, grid.nlon // px
        a_m = self.nn_max + self.k + 1          # overlapped mask apron
        basic = max(1, self.k, self.nn_max)     # basic-path widths
        exact = pipe.params.exact_lon_indexing
        max_w = self.w - 1 if exact else self.w
        if self.overlap == "auto":
            self.overlap = a_m <= self.h and a_m <= max_w
        widest = a_m if self.overlap else basic
        if widest > self.h or widest > max_w:
            raise ValueError(
                f"halo width {widest} (overlap={self.overlap}: mask apron "
                f"nn+k+1={a_m}, basic max(1,k={self.k},nn={self.nn_max})="
                f"{basic}) exceeds the local shard extent {self.h}x{self.w}"
                f"{' minus the quirky-seam margin' if exact else ''} on a "
                f"{py}x{px} mesh; use fewer shards or a finer grid")
        self.tables = device_tables(self.grid_padded, self.k, mesh.device)

    # ------------------------------------------------------------------
    def _exchange(self, local, width: int, lat_fill: str, exact_lon: bool):
        return halo_pad(local, self.mesh, width, width, lat_fill=lat_fill,
                        exact_lon=exact_lon, backend=self.halo_backend)

    def _start(self, local, width: int, exact_lon: bool):
        return halo_start(local, self.mesh, width, width, lat_fill="clamp",
                          exact_lon=exact_lon, backend=self.halo_backend)

    def _offsets(self, s: int):
        iy, ix = self.mesh.coords(s)
        return iy * self.h, ix * self.w

    def _distance(self, cpads, lsm_s, tables):
        params = self.pipeline.params
        return [coast_distance_from_padded(cp, lsm, tab, self.k,
                                           params.maxdist,
                                           impl=self.distance_impl)
                for cp, lsm, tab in zip(cpads, lsm_s, tables)]

    # ------------------------------------------------------------------
    def _core_overlap(self, states, xs, lsm_s, z_s, smods, pres_s, T):
        """Overlapped structure (module docstring).  ``xs`` = per-shard
        (theta, u, v, ci or None) time stacks.  Returns the shards' final
        states and (T, h, w) output stacks."""
        params, mesh = self.pipeline.params, self.mesh
        exact = params.exact_lon_indexing
        h, w, nn, k = self.h, self.w, self.nn_max, self.k
        a_m = nn + k + 1
        dev = mesh.device
        theta_s, u_s, v_s, ci_s = xs

        # once per run: static aprons and the ext blocks' tables
        z_ext, lsm_ext, smod_ext = (self._exchange(f, nn, "clamp", False)
                                    for f in (z_s, lsm_s, smods))
        sdphi2_g, po_g, sdlam2_g = self.tables
        ext_tables, edges = [], []
        for s in range(mesh.size):
            r0, c0 = self._offsets(s)
            gr = torch.arange(r0 - nn, r0 + h + nn, device=dev)
            ridx = gr.clamp(0, self.nlat_pad - 1)
            cidx = torch.arange(c0 - nn, c0 + w + nn, device=dev) % (
                self.grid_padded.nlon)
            ext_tables.append((sdphi2_g.index_select(0, ridx),
                               po_g.index_select(0, ridx),
                               sdlam2_g.index_select(0, cidx)))
            edges.append(((gr < 0)[:, None], (gr >= self.nlat_pad)[:, None]))

        def distance_ext(mask_pads):
            """Signed coast distance on each (h+2nn, w+2nn) ext block, all
            computed from the mask apron; beyond-globe apron rows take the
            globe-edge row (the reference's lat clamp)."""
            cds = self._distance([sobel_edges_from_padded(m)
                                  for m in mask_pads], lsm_ext, ext_tables)
            for s, (below, above) in enumerate(edges):
                iy, _ = mesh.coords(s)
                if iy == 0:
                    cds[s] = torch.where(below, cds[s][nn:nn + 1], cds[s])
                if iy == mesh.py - 1:
                    cds[s] = torch.where(above, cds[s][nn + h - 1:nn + h],
                                         cds[s])
            return cds

        cd_ext0 = None
        if ci_s is None:
            cd_ext0 = distance_ext(self._exchange(
                [make_mask(lsm) for lsm in lsm_s], a_m, "clamp", exact))

        outs = [{key: torch.empty((T, h, w), dtype=torch.float32,
                                  device=dev) for key in OUT_KEYS}
                for _ in range(mesh.size)]
        if self.kernels:
            from ..ops.cuda.ring_kernel import StackedScan
            scans = []
            for s, st in enumerate(states):
                scan = StackedScan(h, w, params, dev)
                o = outs[s]
                o["sb_con"], o["windspeed"], o["winddir"] = scan.init_buffers(
                    T, st.windspeed, st.winddir,
                    row_offset=self._offsets(s)[0], nlat_total=self.nlat_real)
                scans.append(scan)

        inner = (slice(nn, nn + h), slice(nn, nn + w))
        for t in range(T):
            if ci_s is not None:
                fm = self._start([make_mask(lsm, ci[t]) for lsm, ci in
                                  zip(lsm_s, ci_s)], a_m, exact)
            ft = self._start([th[t] for th in theta_s], nn, False)
            # the step's largest independent read, between start and finish
            winds = [wind_at_level(u[t], v[t], p, params.target_plev_pa)
                     for u, v, p in zip(u_s, v_s, pres_s)]
            cd_ext = cd_ext0 if ci_s is None else distance_ext(halo_finish(fm))
            t0_ext = [sea_level_temperature(*a) for a in
                      zip(halo_finish(ft), z_ext, smod_ext)]
            t0 = [e[inner] for e in t0_ext]
            cdist = [e[inner].contiguous() for e in cd_ext]
            if exact:
                t0_ext = quirky_seam_patch(t0_ext, mesh, nn, w)
                cd_ext = quirky_seam_patch(cd_ext, mesh, nn, w)
            for s in range(mesh.size):
                row_offset = self._offsets(s)[0]
                args = (states[s], t0[s], cdist[s], *winds[s], t0_ext[s],
                        cd_ext[s], params, nn)
                o = outs[s]
                if self.kernels:
                    states[s], o["t0"][t] = trigger_core_stacked(
                        *args, t, o["sb_con"], o["windspeed"], o["winddir"],
                        scans[s].add_coastal(cdist[s]), row_offset=row_offset,
                        nlat_total=self.nlat_real)
                else:
                    states[s], out = trigger_core(
                        *args, row_offset=row_offset,
                        nlat_total=self.nlat_real, use_kernels=False)
                    for key in OUT_KEYS:
                        o[key][t] = out[key]
        return states, outs

    # ------------------------------------------------------------------
    def _core_basic(self, states, xs, lsm_s, z_s, smods, pres_s, T):
        """Basic structure: three exchanges per step."""
        params, mesh = self.pipeline.params, self.mesh
        exact = params.exact_lon_indexing
        h, w, k = self.h, self.w, self.k
        theta_s, u_s, v_s, ci_s = xs
        sdphi2_g, po_g, sdlam2_g = self.tables
        tables = []
        for s in range(mesh.size):
            r0, c0 = self._offsets(s)
            tables.append((sdphi2_g[r0:r0 + h], po_g[r0:r0 + h],
                           sdlam2_g[c0:c0 + w]))

        def distance(ci):
            masks = [make_mask(lsm, c) for lsm, c in zip(lsm_s, ci)]
            mpads = self._exchange(masks, 1, "clamp", exact)
            coast = [sobel_edges_from_padded(m) for m in mpads]
            # get_dist uses the clean periodic lon map (sobel.f90:163-164)
            return self._distance(self._exchange(coast, k, "zero", False),
                                  lsm_s, tables)

        cdist0 = distance([None] * mesh.size) if ci_s is None else None
        row_offsets = [self._offsets(s)[0] for s in range(mesh.size)]
        outs = [{key: torch.empty((T, h, w), dtype=torch.float32,
                                  device=mesh.device) for key in OUT_KEYS}
                for _ in range(mesh.size)]
        for t in range(T):
            cdist = (cdist0 if ci_s is None
                     else distance([ci[t] for ci in ci_s]))
            states, step = trigger_step_shards(
                states, [th[t] for th in theta_s], [u[t] for u in u_s],
                [v[t] for v in v_s], cdist, z_s, smods, pres_s, params,
                self.nn_max,
                ring_pad_fn=lambda stacks, nn: self._exchange(stacks, nn,
                                                              "clamp", exact),
                row_offsets=row_offsets, nlat_total=self.nlat_real,
                use_kernels=self.kernels)
            for o, out in zip(outs, step):
                for key in OUT_KEYS:
                    o[key][t] = out[key]
        return states, outs

    # ------------------------------------------------------------------
    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None):
        """Entry point with the arguments of ``TriggerPipeline.run``
        (arrays or tensors, moved to the mesh's device as float32): pads
        lat, splits into shards, runs, gathers, slices back to the real
        rows.  Returns ``(final_state, outputs)``, outputs the four (T,
        nlat, nlon) tensors; ``state`` is not modified."""
        mesh, dev = self.mesh, self.mesh.device

        def shards(a):
            t = torch.as_tensor(a, dtype=torch.float32, device=dev)
            return split(_pad_lat(t, self.nlat_pad), mesh)

        T = int(np.shape(theta_t)[0])
        xs = (shards(theta_t), shards(u_t), shards(v_t),
              None if ci_t is None else shards(ci_t))
        pres_t = torch.as_tensor(pres, dtype=torch.float32, device=dev)
        pres_s = (shards(pres_t) if pres_t.dim() == 3
                  else [pres_t] * mesh.size)
        lsm_s, z_s, std_s = (shards(a) for a in (lsm, z, std))
        states = [TriggerState(int(state.tt), *f) for f in zip(
            *(shards(a) for a in (state.thc, state.windspeed,
                                  state.winddir)))]
        valid = [(torch.arange(r0, r0 + self.h, device=dev)
                  < self.nlat_real)[:, None]
                 for r0 in (self._offsets(s)[0] for s in range(mesh.size))]
        smods = sigmoid_weight_shards(std_s, valid)
        core = self._core_overlap if self.overlap else self._core_basic
        states, outs = core(states, xs, lsm_s, z_s, smods, pres_s, T)

        real = slice(0, self.nlat_real)
        final = TriggerState(states[0].tt, *(
            gather([getattr(st, f) for st in states], mesh)[real]
            for f in ("thc", "windspeed", "winddir")))
        return final, {key: gather([o[key] for o in outs], mesh)[:, real]
                       .contiguous() for key in OUT_KEYS}
