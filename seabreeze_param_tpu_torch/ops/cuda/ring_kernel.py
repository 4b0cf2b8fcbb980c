"""Wrappers of kernels B1, B4 and B5 (``csrc/ring_trigger.cu``), the three
forms of the ring search, replacing the JAX package's
``ops/pallas/ring_kernel.py`` kernels:

* B1 :func:`ring_trigger_cuda_stacked` (``ring_trigger_pallas_stacked``):
  ring search + trigger tail writing slot t of the stacked outputs;
* B4 :func:`ring_trigger_cuda_padded` (``ring_trigger_pallas_padded``):
  the same on every tile, returning the step's sb and new wind state;
* B5 :func:`ring_thc_cuda_padded` (``ring_thc_pallas_padded``): the ring
  search alone.

Plain versions: ``ops.trigger.trigger_cells`` (B1, B4) and
``ops.ring_search.ring_thc_from_padded`` (B5).

:class:`StackedScan` is the counterpart of the JAX package's
``CompactStackedScan``: it owns the kernel's tile grid, the pre-filled
output stacks and the monotone ever-coastal tile mask.  The TPU kernel ran
over a compacted list of the ever-coastal tiles; compacting needs
``torch.nonzero``, which waits for the device, so here the mask stays on
the device, the launch covers the full tile grid, and a block whose tile is
not in the mask returns at once.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import MISSING_VALUE, Params
from . import _build

#: The kernel's tile, (rows, columns) — TH, TW in csrc/ring_trigger.cu.
TILE = (16, 32)


def tile_grid(h: int, w: int):
    """(ni, nj): tile rows and columns covering an (h, w) field."""
    return -(-h // TILE[0]), -(-w // TILE[1])


def coastal_tile_pred(cdist, maxdist: float):
    """(ni*nj,) uint8, row-major: 1 where the tile holds a cell with
    |cdist| <= maxdist."""
    h, w = cdist.shape
    ni, nj = tile_grid(h, w)
    c = (cdist.abs() <= float(np.float32(maxdist))).to(torch.uint8)
    c = F.pad(c, (0, nj * TILE[1] - w, 0, ni * TILE[0] - h))
    return c.reshape(ni, TILE[0], nj, TILE[1]).amax(dim=(1, 3)).reshape(-1)


class StackedScan:
    """Tile grid, pre-filled (T, h, w) output stacks and the ever-coastal
    launch set of one scan over T steps.

    The pre-fill IS the result of a tile that never becomes coastal:
    MISSING sb_con and the initial wind passed through (zero in the
    reference's unwritten last row).  That is exact because the wind state
    only changes on coastal cells; it is why the set of visited tiles must
    be monotone over the scan.
    """

    def __init__(self, h: int, w: int, params: Params, device):
        self.h, self.w = int(h), int(w)
        self.params = params
        self.device = torch.device(device)
        self.ever = torch.zeros(int(np.prod(tile_grid(h, w))),
                                dtype=torch.uint8, device=self.device)

    def init_buffers(self, T: int, windspeed0, winddir0, *,
                     row_offset: int = 0, nlat_total: int | None = None):
        """Pre-filled (sb, ws, wd) stacks of shape (T, h, w); a shard's
        block passes its ``row_offset`` in the ``nlat_total``-row grid, so
        the unwritten last row is the global one."""
        from ..trigger import row_mask
        row_ok = row_mask(self.h, self.params, self.device, row_offset,
                          nlat_total)
        shape = (T, self.h, self.w)
        sb = torch.where(row_ok, float(MISSING_VALUE), 0.0)
        ws = torch.where(row_ok, windspeed0, 0.0)
        wd = torch.where(row_ok, winddir0, 0.0)
        return tuple(a.expand(shape).contiguous() for a in (sb, ws, wd))

    def add_coastal(self, cdist):
        """Grow the ever-coastal set with this step's band, in place."""
        self.ever |= coastal_tile_pred(cdist, self.params.maxdist)
        return self.ever


def ring_trigger_cuda_stacked(t0_pad, cd_pad, cd_center, ws_new, wd_new,
                              ws_state, wd_state, is_first: bool, upd: bool,
                              params: Params, nn_max: int, step_idx: int,
                              sb_buf, ws_buf, wd_buf, ever, *,
                              row_offset: int = 0,
                              nlat_total: int | None = None):
    """Ring search + trigger tail for one step, written IN PLACE.

    ``t0_pad``/``cd_pad`` (h+2NN, w+2NN); ``cd_center``, ``ws_new``,
    ``wd_new``, ``ws_state``, ``wd_state`` (h, w); ``sb_buf``/``ws_buf``/
    ``wd_buf`` (T, h, w); ``ever`` the (ni*nj,) uint8 tile mask of
    :class:`StackedScan`.  Slot ``step_idx`` of the three stacks is
    overwritten on the tiles set in ``ever``, and ``ws_state``/``wd_state``
    are updated in place there; everything else keeps its contents.  The
    field is rows ``row_offset``.. of an ``nlat_total``-row grid (default:
    the whole grid), which places the reference's unwritten last row.

    A CUDA tensor launches the kernel on the current stream (one launch,
    counted in ``ring_trigger_cuda_stacked.launches``); a CPU tensor takes
    the plain version, written over the whole field (equal, by the
    pre-fill invariant of :class:`StackedScan`).  Returns nothing.
    """
    NN = int(nn_max)
    h, w = cd_center.shape
    step_idx = int(step_idx)
    row_offset = int(row_offset)
    nlat_total = h if nlat_total is None else int(nlat_total)
    if t0_pad.device.type == "cpu":
        from ..trigger import trigger_cells
        sb, out_ws, out_wd, ws_st, wd_st = trigger_cells(
            cd_center, ws_new, wd_new, ws_state, wd_state, t0_pad, cd_pad,
            is_first, upd, params, NN, row_offset=row_offset,
            nlat_total=nlat_total)
        sb_buf[step_idx] = sb
        ws_buf[step_idx] = out_ws
        wd_buf[step_idx] = out_wd
        ws_state.copy_(ws_st)
        wd_state.copy_(wd_st)
        return

    dev = t0_pad.device
    T = sb_buf.shape[0]
    if not 0 <= step_idx < T:
        raise ValueError(f"step_idx {step_idx} outside the {T} slots")
    for name, t, shape in (
            ("t0_pad", t0_pad, (h + 2 * NN, w + 2 * NN)),
            ("cd_pad", cd_pad, (h + 2 * NN, w + 2 * NN)),
            ("cd_center", cd_center, (h, w)), ("ws_new", ws_new, (h, w)),
            ("wd_new", wd_new, (h, w)), ("ws_state", ws_state, (h, w)),
            ("wd_state", wd_state, (h, w)), ("sb_buf", sb_buf, (T, h, w)),
            ("ws_buf", ws_buf, (T, h, w)), ("wd_buf", wd_buf, (T, h, w))):
        _build.require(t, name, shape, dev)
    _build.require(ever, "ever", (int(np.prod(tile_grid(h, w))),), dev,
                   dtype=torch.uint8)
    f32 = np.float32
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sbz_ring_trigger_stacked(
            t0_pad.data_ptr(), cd_pad.data_ptr(), cd_center.data_ptr(),
            ws_new.data_ptr(), wd_new.data_ptr(), ws_state.data_ptr(),
            wd_state.data_ptr(), ever.data_ptr(), sb_buf.data_ptr(),
            ws_buf.data_ptr(), wd_buf.data_ptr(), h, w, NN, step_idx,
            int(bool(is_first)), int(bool(upd)), row_offset, nlat_total,
            int(bool(params.skip_last_lat_row)), *(
                float(f32(x)) for x in (
                    params.maxdist, params.thresh_wind, params.thresh_winddir,
                    params.thresh_windch, params.thresh_thc)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ring_trigger_cuda_stacked")
    ring_trigger_cuda_stacked.launches += 1


ring_trigger_cuda_stacked.launches = 0


def _require_pads(t0_pad, cd_pad, cd_center, NN: int):
    h, w = cd_center.shape
    dev = t0_pad.device
    for name, t in (("t0_pad", t0_pad), ("cd_pad", cd_pad)):
        _build.require(t, name, (h + 2 * NN, w + 2 * NN), dev)
    _build.require(cd_center, "cd_center", (h, w), dev)
    return h, w, dev


def ring_trigger_cuda_padded(t0_pad, cd_pad, cd_center, ws_new, wd_new,
                             ws_state, wd_state, is_first: bool, upd: bool,
                             params: Params, nn_max: int, *,
                             row_offset: int = 0,
                             nlat_total: int | None = None):
    """Kernel B4: ring search + trigger tail for one step over every tile.

    ``t0_pad``/``cd_pad`` (h+2NN, w+2NN); ``cd_center``, ``ws_new``,
    ``wd_new``, ``ws_state``, ``wd_state`` (h, w).  Returns ``(sb, ws', wd')``
    (h, w): the step's sb_con (zero in the reference's unwritten last row)
    and the new wind state (frozen in that row).  The inputs are not
    modified.  ``row_offset``/``nlat_total`` as for B1.

    A CUDA tensor launches the kernel on the current stream (one launch,
    counted in ``ring_trigger_cuda_padded.launches``); a CPU tensor takes
    the plain version, ``ops.trigger.trigger_cells``.
    """
    NN = int(nn_max)
    row_offset = int(row_offset)
    if t0_pad.device.type == "cpu":
        from ..trigger import trigger_cells
        sb, _, _, ws_st, wd_st = trigger_cells(
            cd_center, ws_new, wd_new, ws_state, wd_state, t0_pad, cd_pad,
            is_first, upd, params, NN, row_offset=row_offset,
            nlat_total=nlat_total)
        return sb, ws_st, wd_st

    h, w, dev = _require_pads(t0_pad, cd_pad, cd_center, NN)
    nlat_total = h if nlat_total is None else int(nlat_total)
    for name, t in (("ws_new", ws_new), ("wd_new", wd_new),
                    ("ws_state", ws_state), ("wd_state", wd_state)):
        _build.require(t, name, (h, w), dev)
    sb, ws_o, wd_o = (torch.empty((h, w), dtype=torch.float32, device=dev)
                      for _ in range(3))
    f32 = np.float32
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sbz_ring_trigger_padded(
            t0_pad.data_ptr(), cd_pad.data_ptr(), cd_center.data_ptr(),
            ws_new.data_ptr(), wd_new.data_ptr(), ws_state.data_ptr(),
            wd_state.data_ptr(), sb.data_ptr(), ws_o.data_ptr(),
            wd_o.data_ptr(), h, w, NN, int(bool(is_first)), int(bool(upd)),
            row_offset, nlat_total, int(bool(params.skip_last_lat_row)), *(
                float(f32(x)) for x in (
                    params.maxdist, params.thresh_wind, params.thresh_winddir,
                    params.thresh_windch, params.thresh_thc)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ring_trigger_cuda_padded")
    ring_trigger_cuda_padded.launches += 1
    return sb, ws_o, wd_o


ring_trigger_cuda_padded.launches = 0


def ring_thc_cuda_padded(t0_pad, cd_pad, cd_center, nn_max: int, *,
                         maxdist: float = 180.0):
    """Kernel B5: the ring search alone.  ``t0_pad``/``cd_pad``
    (h+2NN, w+2NN), ``cd_center`` (h, w) -> n_thc (h, w), zero off the
    band |cd_center| <= maxdist.

    A CUDA tensor launches the kernel (counted in
    ``ring_thc_cuda_padded.launches``); a CPU tensor takes the plain
    version, ``ring_thc_from_padded(ring_quantities(t0_pad, cd_pad), mul,
    NN, coastal=...)``.
    """
    NN = int(nn_max)
    if t0_pad.device.type == "cpu":
        from ..ring_search import ring_quantities, ring_thc_from_padded
        mul = torch.where(cd_center >= 0.0, 1.0, -1.0)
        coastal = cd_center.abs() <= float(np.float32(maxdist))
        return ring_thc_from_padded(ring_quantities(t0_pad, cd_pad), mul, NN,
                                    coastal=coastal)[0]

    h, w, dev = _require_pads(t0_pad, cd_pad, cd_center, NN)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sbz_ring_thc_padded(
            t0_pad.data_ptr(), cd_pad.data_ptr(), cd_center.data_ptr(),
            out.data_ptr(), h, w, NN, float(np.float32(maxdist)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ring_thc_cuda_padded")
    ring_thc_cuda_padded.launches += 1
    return out


ring_thc_cuda_padded.launches = 0
