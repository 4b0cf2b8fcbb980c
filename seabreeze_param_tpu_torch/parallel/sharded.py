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
kernel path runs per shard kernel B3 (B2 with ``distance_impl='hybrid'``)
on the apron-extended block and kernel B1 through a per-shard
``StackedScan``.

**Basic.**  Three exchanges per step (mask 1-wide, coast k-wide with zero
lat fill, the ``[t0, cdist]`` ring inputs nn-wide in one launch), for
shards too small for the apron; kernels B3 and B4.  Unlike the JAX
package, whose DMA exchange served the basic structure only, the kernel
exchange here serves both.

Why the apron form is exact, and why edge-row replication padding of the
lat axis to a multiple of the mesh rows is (global statistics leave the
padding rows out through ``valid_mask``; outputs are sliced back to the
real rows): see the JAX module's docstring, which this port follows step
for step.

Pass 1's nearest lon form (the pipeline's ``distance_lon_form``) is
checked on the global grid and k, as in the JAX package, and each shard's
distance takes its ``half_dlam``.

Over a multi-process mesh (``parallel.distributed``) each process runs its
own block of mesh rows (:meth:`ShardedPipeline.run_block`): the halo-width
guard and the choice of structure stay per shard, the lat padding, the
tables and the row offsets come from the global grid, a process edge's
halo rows from the neighbouring process, and the sigmoid's statistics are
gathered over every process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import TriggerState
from ..models.pipeline import TriggerPipeline, _f32
from ..ops.coastline import make_mask, sobel_edges_from_padded
from ..ops.distance import (coast_distance_from_padded, device_tables,
                             uniform_half_dlam)
from ..ops.orography import sigmoid_weight_shards
from ..ops.trigger import (sea_level_temperature, trigger_core,
                           trigger_core_stacked, trigger_step_shards,
                           wind_at_level)
from .halo import (halo_finish, halo_pad, halo_start, quirky_seam_patch,
                   resolve_backend)
from .mesh import ShardMesh, gather, split

OUT_KEYS = ("sb_con", "t0", "windspeed", "winddir")


def take_rows(a, rows, dev):
    """The rows ``rows`` (dim -2; an index array) of an array or tensor, as
    a float32 tensor on ``dev``; a host array is indexed on the host."""
    if isinstance(a, torch.Tensor):
        return _f32(a, dev).index_select(a.dim() - 2,
                                         torch.as_tensor(rows, device=dev))
    return _f32(np.take(np.asarray(a), rows, axis=-2), dev)


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
    the global mesh rows; on a multi-process mesh this process owns the
    padded rows ``[row_lo, row_hi)``.  ``overlap`` — ``'auto'``
    (default): the overlapped structure whenever the mask apron fits the
    shard, else basic; True/False force it.  ``halo_backend`` — ``'auto'`` (default): ``'kernel'`` (B6; its
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
        py_all = mesh.global_shape[0]
        self.nlat_real = grid.nlat
        self.nlat_pad = -(-grid.nlat // py_all) * py_all
        lat_idx = np.minimum(np.arange(self.nlat_pad), grid.nlat - 1)
        self.grid_padded = Grid(lon=grid.lon, lat=grid.lat[lat_idx])
        self.k, self.nn_max = pipe.k, pipe.nn_max
        self.kernels = pipe.kernels
        self.halo_backend = resolve_backend(self.halo_backend,
                                            pipe.use_kernels)
        self.distance_impl = ("plain" if pipe.use_kernels is False
                              else pipe.distance_impl)
        # the nearest lon form, checked on the global grid and k
        self.half_dlam = None
        if pipe.distance_lon_form == "nearest":
            self.half_dlam = uniform_half_dlam(grid, self.k)
            if self.half_dlam is None:
                raise ValueError(
                    "distance_lon_form='nearest' needs a uniform global "
                    "lon axis with k*dlam <= 180 deg")
        # Halo-width guard: every exchanged width must fit inside one
        # shard, in lon strictly when the quirky seam patches are on (at
        # hx == w the copy of global column nlon-1 in a neighbour's
        # opposite halo has no patch position).
        self.h, self.w = self.nlat_pad // py_all, grid.nlon // px
        self.row_lo = mesh.row0 * self.h
        self.row_hi = self.row_lo + py * self.h
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
        """Global (row, column) of shard ``s``'s first cell."""
        iy, ix = self.mesh.coords(s)
        return self.row_lo + iy * self.h, ix * self.w

    def _distance(self, cpads, lsm_s, tables):
        params = self.pipeline.params
        return [coast_distance_from_padded(cp, lsm, tab, self.k,
                                           params.maxdist,
                                           impl=self.distance_impl,
                                           half_dlam=self.half_dlam)
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
        ext_tables, edges = [], []
        for s in range(mesh.size):
            r0, c0 = self._offsets(s)
            gr = torch.arange(r0 - nn, r0 + h + nn, device=dev)
            ridx = gr.clamp(0, self.nlat_pad - 1)
            cidx = torch.arange(c0 - nn, c0 + w + nn, device=dev) % (
                self.grid_padded.nlon)
            ext_tables.append(self.tables.select(ridx, cidx))
            edges.append(((gr < 0)[:, None], (gr >= self.nlat_pad)[:, None]))

        def distance_ext(mask_pads):
            """Signed coast distance on each (h+2nn, w+2nn) ext block, all
            computed from the mask apron; beyond-globe apron rows take the
            globe-edge row (the reference's lat clamp)."""
            cds = self._distance([sobel_edges_from_padded(m)
                                  for m in mask_pads], lsm_ext, ext_tables)
            for s, (below, above) in enumerate(edges):
                r0 = self._offsets(s)[0]
                if r0 == 0:
                    cds[s] = torch.where(below, cds[s][nn:nn + 1], cds[s])
                if r0 + h == self.nlat_pad:
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
        tables = []
        for s in range(mesh.size):
            r0, c0 = self._offsets(s)
            tables.append(self.tables.select(slice(r0, r0 + h),
                                             slice(c0, c0 + w)))

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
        lat, takes this process's rows, runs them (:meth:`run_block`),
        gathers every process's rows and slices back to the real rows.
        Returns ``(final_state, outputs)``, outputs the four (T, nlat,
        nlon) tensors; ``state`` is not modified."""
        dev = self.mesh.device
        if self.mesh.world == 1:
            def block(a):
                return _pad_lat(_f32(a, dev), self.nlat_pad)
        else:
            rows = np.minimum(np.arange(self.row_lo, self.row_hi),
                              self.nlat_real - 1)

            def block(a):
                return take_rows(a, rows, dev)

        pres_b = block(pres) if np.ndim(pres) == 3 else pres
        final, outs = self.run_block(
            TriggerState(state.tt, *(block(getattr(state, f)) for f in
                                     ("thc", "windspeed", "winddir"))),
            block(theta_t), block(u_t), block(v_t), block(lsm), block(z),
            block(std), pres_b, ci_t=None if ci_t is None else block(ci_t))
        if self.mesh.world > 1:
            from .distributed import gather_rows
            span = self.row_hi - self.row_lo
            final = TriggerState(final.tt, *(
                gather_rows(getattr(final, f), span, self.nlat_pad)
                for f in ("thc", "windspeed", "winddir")))
            outs = {key: gather_rows(o, span, self.nlat_pad)
                    for key, o in outs.items()}
        real = slice(0, self.nlat_real)
        return (TriggerState(final.tt, final.thc[real], final.windspeed[real],
                             final.winddir[real]),
                {key: o[:, real].contiguous() for key, o in outs.items()})

    def run_block(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std,
                  pres, ci_t=None):
        """Run this process's block: every field argument is the rows
        ``[row_lo, row_hi)`` of the lat-padded global field (``pres`` 1-D,
        or its block of a 3-D field).  Returns ``(final_state, outputs)``
        of those rows, padding rows included, as tensors on the mesh's
        device."""
        mesh, dev = self.mesh, self.mesh.device

        def shards(a):
            return split(_f32(a, dev), mesh)

        T = int(np.shape(theta_t)[0])
        xs = (shards(theta_t), shards(u_t), shards(v_t),
              None if ci_t is None else shards(ci_t))
        pres_t = _f32(pres, dev)
        pres_s = (shards(pres_t) if pres_t.dim() == 3
                  else [pres_t] * mesh.size)
        lsm_s, z_s, std_s = (shards(a) for a in (lsm, z, std))
        states = [TriggerState(int(state.tt), *f) for f in zip(
            *(shards(a) for a in (state.thc, state.windspeed,
                                  state.winddir)))]
        valid = [(torch.arange(r0, r0 + self.h, device=dev)
                  < self.nlat_real)[:, None]
                 for r0 in (self._offsets(s)[0] for s in range(mesh.size))]
        if mesh.world > 1:
            from .distributed import all_gather_cat
            smods = sigmoid_weight_shards(std_s, valid, all_gather_cat)
        else:
            smods = sigmoid_weight_shards(std_s, valid)
        core = self._core_overlap if self.overlap else self._core_basic
        states, outs = core(states, xs, lsm_s, z_s, smods, pres_s, T)
        final = TriggerState(states[0].tt, *(
            gather([getattr(st, f) for st in states], mesh)
            for f in ("thc", "windspeed", "winddir")))
        return final, {key: gather([o[key] for o in outs], mesh)
                       for key in OUT_KEYS}
