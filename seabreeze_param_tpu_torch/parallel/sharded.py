"""The decomposed trigger pipeline over a shard mesh; counterpart of
``seabreeze_param_tpu.parallel.sharded``.

The JAX package runs the per-shard scan under ``shard_map``, one shard per
device, with ``ppermute`` exchanges (or its DMA kernel) between them.  Here
one process drives every shard of a :class:`parallel.mesh.ShardMesh`, whose
groups of shards may lie on several cards (or several times on one): each
step runs each group's shards one after another, each on its own
launches, on the group's device, and every halo exchange serves all shards
at once through ``parallel.halo`` — on the kernel path one launch of
kernel B6 per group.  On the kernel path a mesh of several groups queues
each group's work on the group's own stream (``parallel.mesh.on_group``),
so groups on separate cards run at once; the exchanges order them
(``ops.cuda.halo_kernel``).  The plain path runs the groups on the cards'
current streams.  The sigmoid's global statistics are combined over the
shard list in shard order on the first group's device
(``ops.orography.sigmoid_weight_shards``); outputs are gathered there.

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
own block of mesh rows (:meth:`ShardedPipeline.run_block`), over one group
or several, as on one process: the halo-width guard and the choice of
structure stay per shard, the lat padding, the tables and the row offsets
come from the global grid, a process edge's halo rows from the
neighbouring process (delivered to the cards of the groups that read
them), and the sigmoid's statistics are gathered over every process.
"""
from __future__ import annotations

import contextlib
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
                           trigger_core_stacked, wind_at_level)
from .halo import (halo_finish, halo_pad, halo_start, resolve_backend,
                   seam_patch)
from .mesh import ShardMesh, fork, gather, join, on_group, split

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
    (default): the overlapped structure whenever the mask apron of the
    run's NN fits the shard, else basic; True/False force it
    (:meth:`overlapped`).  ``halo_backend`` — ``'auto'`` (default):
    ``'kernel'`` (B6; its plain version for CPU tensors) unless the
    pipeline has ``use_kernels=False``, then ``'plain'``.  The JAX package's
    ``'ppermute'`` and ``'dma'`` are ``'plain'`` and ``'kernel'`` here.
    The shards live on their groups' devices, of the pipeline's device
    type; the outputs on ``mesh.device``.
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
                             f"{[str(d) for d in mesh.devices]}")
        if grid.nlon % px:
            raise ValueError(f"nlon={grid.nlon} not divisible by mesh x={px}")
        py_all = mesh.global_shape[0]
        self.nlat_real = grid.nlat
        self.nlat_pad = -(-grid.nlat // py_all) * py_all
        lat_idx = np.minimum(np.arange(self.nlat_pad), grid.nlat - 1)
        self.grid_padded = Grid(lon=grid.lon, lat=grid.lat[lat_idx])
        self.k = pipe.k
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
        self.h, self.w = self.nlat_pad // py_all, grid.nlon // px
        self.row_lo = mesh.row0 * self.h
        self.row_hi = self.row_lo + py * self.h
        self.tables = {dev: device_tables(self.grid_padded, self.k, dev)
                       for dev in dict.fromkeys(mesh.devices)}
        # the kernel path gives each group a stream of its own
        self.streams = self.halo_backend == "kernel"

    def overlapped(self, nn=None) -> bool:
        """Whether a run at ring radius ``nn`` (None: the pipeline's
        ``nn_max``) takes the overlapped structure.  Halo-width guard:
        raises ValueError where an exchanged width of that structure does
        not fit inside one shard, in lon strictly when the quirky seam
        patches are on (at hx == w the copy of global column nlon-1 in a
        neighbour's opposite halo has no patch position)."""
        nn = self.pipeline.nn_max if nn is None else nn
        a_m = nn + self.k + 1                   # overlapped mask apron
        basic = max(1, self.k, nn)              # basic-path widths
        exact = self.pipeline.params.exact_lon_indexing
        max_w = self.w - 1 if exact else self.w
        overlap = self.overlap
        if overlap == "auto":
            overlap = a_m <= self.h and a_m <= max_w
        widest = a_m if overlap else basic
        if widest > self.h or widest > max_w:
            raise ValueError(
                f"halo width {widest} (overlap={overlap}: mask apron "
                f"nn+k+1={a_m}, basic max(1,k={self.k},nn={nn})={basic}) "
                f"exceeds the local shard extent {self.h}x{self.w}"
                f"{' minus the quirky-seam margin' if exact else ''} on a "
                f"{self.mesh.shape[0]}x{self.mesh.shape[1]} mesh; use fewer "
                f"shards or a finer grid")
        return overlap

    # ------------------------------------------------------------------
    def _groups(self):
        """Each group's shards in turn, the loop's body queued on the
        group's device and, on the kernel path, its stream."""
        for g in range(self.mesh.groups):
            with (on_group(self.mesh, g) if self.streams
                  else contextlib.nullcontext()):
                yield self.mesh.group_shards(g)

    def _map(self, fn):
        """``[fn(s) for s in range(mesh.size)]``, each shard's call on its
        group (:meth:`_groups`)."""
        out = [None] * self.mesh.size
        for shards in self._groups():
            for s in shards:
                out[s] = fn(s)
        return out

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

    def _distance(self, cpad, lsm, tables):
        params = self.pipeline.params
        return coast_distance_from_padded(cpad, lsm, tables, self.k,
                                          params.maxdist,
                                          impl=self.distance_impl,
                                          half_dlam=self.half_dlam)

    def _outputs(self, T):
        """Each shard's (T, h, w) output stacks, on its device."""
        return self._map(lambda s: {
            key: torch.empty((T, self.h, self.w), dtype=torch.float32,
                             device=self.mesh.device_of(s))
            for key in OUT_KEYS})

    # ------------------------------------------------------------------
    def _core_overlap(self, states, xs, lsm_s, z_s, smods, pres_s, T, nn):
        """Overlapped structure (module docstring).  ``xs`` = per-shard
        (theta, u, v, ci or None) time stacks.  Returns the shards' final
        states and (T, h, w) output stacks."""
        params, mesh = self.pipeline.params, self.mesh
        exact = params.exact_lon_indexing
        h, w, k = self.h, self.w, self.k
        a_m = nn + k + 1
        theta_s, u_s, v_s, ci_s = xs

        # once per run: static aprons and the ext blocks' tables
        z_ext, lsm_ext, smod_ext = (self._exchange(f, nn, "clamp", False)
                                    for f in (z_s, lsm_s, smods))

        def ext_table(s):
            dev = mesh.device_of(s)
            r0, c0 = self._offsets(s)
            gr = torch.arange(r0 - nn, r0 + h + nn, device=dev)
            ridx = gr.clamp(0, self.nlat_pad - 1)
            cidx = torch.arange(c0 - nn, c0 + w + nn, device=dev) % (
                self.grid_padded.nlon)
            return (self.tables[dev].select(ridx, cidx),
                    ((gr < 0)[:, None], (gr >= self.nlat_pad)[:, None]))

        ext = self._map(ext_table)

        def distance_ext(s, mask_pad):
            """Signed coast distance on shard s's (h+2nn, w+2nn) ext block,
            computed from the mask apron; beyond-globe apron rows take the
            globe-edge row (the reference's lat clamp)."""
            tables, (below, above) = ext[s]
            cd = self._distance(sobel_edges_from_padded(mask_pad),
                                lsm_ext[s], tables)
            r0 = self._offsets(s)[0]
            if r0 == 0:
                cd = torch.where(below, cd[nn:nn + 1], cd)
            if r0 + h == self.nlat_pad:
                cd = torch.where(above, cd[nn + h - 1:nn + h], cd)
            return cd

        cd_ext0 = None
        if ci_s is None:
            mpads = self._exchange(self._map(lambda s: make_mask(lsm_s[s])),
                                   a_m, "clamp", exact)
            cd_ext0 = self._map(lambda s: distance_ext(s, mpads[s]))

        outs = self._outputs(T)
        if self.kernels:
            from ..ops.cuda.ring_kernel import StackedScan

            def scan(s):
                sc = StackedScan(h, w, params, mesh.device_of(s))
                o, st = outs[s], states[s]
                o["sb_con"], o["windspeed"], o["winddir"] = sc.init_buffers(
                    T, st.windspeed, st.winddir,
                    row_offset=self._offsets(s)[0], nlat_total=self.nlat_real)
                return sc

            scans = self._map(scan)

        inner = (slice(nn, nn + h), slice(nn, nn + w))
        for t in range(T):
            if ci_s is not None:
                fm = self._start(self._map(
                    lambda s: make_mask(lsm_s[s], ci_s[s][t])), a_m, exact)
            ft = self._start([th[t] for th in theta_s], nn, False)
            # the step's largest independent read, between start and finish
            winds = self._map(lambda s: wind_at_level(
                u_s[s][t], v_s[s][t], pres_s[s], params.target_plev_pa))
            mpads = None if ci_s is None else halo_finish(fm)
            tpads = halo_finish(ft)
            for shards in self._groups():
                for s in shards:
                    cd_ext = (cd_ext0[s] if ci_s is None
                              else distance_ext(s, mpads[s]))
                    t0_ext = sea_level_temperature(tpads[s], z_ext[s],
                                                   smod_ext[s])
                    t0 = t0_ext[inner]
                    cdist = cd_ext[inner].contiguous()
                    if exact:
                        ix = mesh.coords(s)[1]
                        t0_ext = seam_patch(t0_ext, ix, mesh.px, nn, w)
                        cd_ext = seam_patch(cd_ext, ix, mesh.px, nn, w)
                    row_offset = self._offsets(s)[0]
                    args = (states[s], t0, cdist, *winds[s], t0_ext, cd_ext,
                            params, nn)
                    o = outs[s]
                    if self.kernels:
                        states[s], o["t0"][t] = trigger_core_stacked(
                            *args, t, o["sb_con"], o["windspeed"],
                            o["winddir"], scans[s].add_coastal(cdist),
                            row_offset=row_offset, nlat_total=self.nlat_real)
                    else:
                        states[s], out = trigger_core(
                            *args, row_offset=row_offset,
                            nlat_total=self.nlat_real, use_kernels=False)
                        for key in OUT_KEYS:
                            o[key][t] = out[key]
        return states, outs

    # ------------------------------------------------------------------
    def _core_basic(self, states, xs, lsm_s, z_s, smods, pres_s, T, nn):
        """Basic structure: three exchanges per step (the JAX package's
        ``trigger_step`` with a ``ring_pad_fn``)."""
        params, mesh = self.pipeline.params, self.mesh
        exact = params.exact_lon_indexing
        h, w, k = self.h, self.w, self.k
        theta_s, u_s, v_s, ci_s = xs

        def table(s):
            r0, c0 = self._offsets(s)
            return self.tables[mesh.device_of(s)].select(
                slice(r0, r0 + h), slice(c0, c0 + w))

        tables = self._map(table)

        def distance(ci):
            mpads = self._exchange(self._map(
                lambda s: make_mask(lsm_s[s], ci[s])), 1, "clamp", exact)
            coast = self._map(lambda s: sobel_edges_from_padded(mpads[s]))
            # get_dist uses the clean periodic lon map (sobel.f90:163-164)
            cpads = self._exchange(coast, k, "zero", False)
            return self._map(lambda s: self._distance(cpads[s], lsm_s[s],
                                                      tables[s]))

        cdist0 = distance([None] * mesh.size) if ci_s is None else None
        outs = self._outputs(T)
        for t in range(T):
            cdist = (cdist0 if ci_s is None
                     else distance([ci[t] for ci in ci_s]))

            def prepare(s):
                t0 = sea_level_temperature(theta_s[s][t], z_s[s], smods[s])
                return t0, wind_at_level(u_s[s][t], v_s[s][t], pres_s[s],
                                         params.target_plev_pa)

            prep = self._map(prepare)
            # the ring inputs [t0, cdist] of every shard in one exchange
            pads = self._exchange(self._map(
                lambda s: torch.stack((prep[s][0], cdist[s]))), nn, "clamp",
                exact)
            for shards in self._groups():
                for s in shards:
                    t0, (ws, wd) = prep[s]
                    states[s], out = trigger_core(
                        states[s], t0, cdist[s], ws, wd, pads[s][0],
                        pads[s][1], params, nn,
                        row_offset=self._offsets(s)[0],
                        nlat_total=self.nlat_real, use_kernels=self.kernels)
                    for key in OUT_KEYS:
                        outs[s][key][t] = out[key]
        return states, outs

    # ------------------------------------------------------------------
    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None, *, nn=None):
        """Entry point with the arguments of ``TriggerPipeline.run``
        (arrays or tensors, moved to the mesh's device as float32): pads
        lat, takes this process's rows, runs them (:meth:`run_block`),
        gathers every process's rows and slices back to the real rows.
        Returns ``(final_state, outputs)``, outputs the four (T, nlat,
        nlon) tensors on ``mesh.device``; ``state`` is not modified."""
        self.overlapped(nn)                 # refuse before moving a field
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
            block(std), pres_b, ci_t=None if ci_t is None else block(ci_t),
            nn=nn)
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
                  pres, ci_t=None, *, nn=None):
        """Run this process's block at ring radius ``nn`` (None: the
        pipeline's ``nn_max``): every field argument is the rows
        ``[row_lo, row_hi)`` of the lat-padded global field (``pres`` 1-D,
        or its block of a 3-D field).  Returns ``(final_state, outputs)``
        of those rows, padding rows included, as tensors on the mesh's
        device."""
        nn = self.pipeline.nn_max if nn is None else nn
        core = self._core_overlap if self.overlapped(nn) else self._core_basic
        mesh, dev = self.mesh, self.mesh.device

        def shards(a):
            return split(_f32(a, dev), mesh)

        T = int(np.shape(theta_t)[0])
        xs = (shards(theta_t), shards(u_t), shards(v_t),
              None if ci_t is None else shards(ci_t))
        pres_t = _f32(pres, dev)
        pres_s = (shards(pres_t) if pres_t.dim() == 3
                  else [pres_t.to(mesh.device_of(s))
                        for s in range(mesh.size)])
        lsm_s, z_s, std_s = (shards(a) for a in (lsm, z, std))
        states = [TriggerState(int(state.tt), *f) for f in zip(
            *(shards(a) for a in (state.thc, state.windspeed,
                                  state.winddir)))]
        valid = [(torch.arange(r0, r0 + self.h, device=mesh.device_of(s))
                  < self.nlat_real)[:, None]
                 for s, r0 in ((s, self._offsets(s)[0])
                               for s in range(mesh.size))]
        if mesh.world > 1:
            from .distributed import all_gather_cat
            smods = sigmoid_weight_shards(std_s, valid, all_gather_cat)
        else:
            smods = sigmoid_weight_shards(std_s, valid)
        if self.streams:
            fork(mesh)
        states, outs = core(states, xs, lsm_s, z_s, smods, pres_s, T, nn)
        if self.streams:
            join(mesh)
        final = TriggerState(states[0].tt, *(
            gather([getattr(st, f) for st in states], mesh)
            for f in ("thc", "windspeed", "winddir")))
        return final, {key: gather([o[key] for o in outs], mesh)
                       for key in OUT_KEYS}
