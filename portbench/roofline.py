"""The yardstick of the kernels' roofline shares: published peaks, and the
least work the inputs of a step need from the ring search (B1, B4) and the
coast distance (B3), whatever implements them.

The arithmetic is copied from the port's smoke script (``timing``'s bound,
``ring_work`` with its fixed ``BOUND_TILE`` and ``RING_ADDS``, and
``b3_bound``), so that every design of a kernel is held to the same bound.
The work is counted from the plain reference's fields (``reference/``), not
from anything the program made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
#: memory in bytes/s and float32 outside the tensor cores in operations/s.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

#: The bound's unit of B1's work: the tile of the kernels' parent design, so
#: that every design of B1 is held to the same bound.
BOUND_TILE = (16, 32)
#: Float32 additions per cell and radius of the ring search: three
#: channels, four window terms and the two running sums' two terms each.
RING_ADDS = 3 * (4 + 2 + 2)


def bound(nbytes: float, ops: float):
    """``(seconds, by)``: the least time the card could take for ``nbytes``
    moved and ``ops`` float32 operations, the larger of bytes over the
    memory rate and operations over the float32 rate, and which of the two
    it is (``'bytes'`` or ``'operations'``)."""
    by_bytes, by_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def ring_work(radii, tile=BOUND_TILE):
    """The ring search's work on one step, in units of ``tile``: ``(tiles,
    cells, adds)`` — the tiles that hold a coastal cell, the field's cells
    inside them, and the ring additions those tiles need, each running the
    radii of its slowest coastal cell.  ``radii`` (h, w) int: the radius at
    which each coastal cell latches (the first whose window holds land and
    sea), 0 off the coastal band."""
    th, tw = tile
    h, w = radii.shape
    ni, nj = -(-h // th), -(-w // tw)
    r = F.pad(radii.to(torch.int64), (0, nj * tw - w, 0, ni * th - h))
    inside = F.pad(torch.ones_like(radii, dtype=torch.int64),
                   (0, nj * tw - w, 0, ni * th - h))
    most = r.reshape(ni, th, nj, tw).amax(dim=(1, 3)).reshape(-1)
    cells = inside.reshape(ni, th, nj, tw).sum(dim=(1, 3)).reshape(-1)
    run = most > 0
    return (int(run.sum()), int(cells[run].sum()),
            int((cells * most)[run].sum()) * RING_ADDS)


def b1_work(radii):
    """``(bytes, operations)`` of one step of B1, the stacked ring search
    and trigger: 28 bytes in and 20 out per cell of the tiles holding a
    coastal cell, one byte a tile of the coastal tile mask, and the ring
    additions of :func:`ring_work`."""
    th, tw = BOUND_TILE
    h, w = radii.shape
    tiles, cells, adds = ring_work(radii)
    return 48 * cells + (-(-h // th)) * (-(-w // tw)), adds


def b4_work(radii):
    """``(bytes, operations)`` of one step of B4, the padded ring search
    and trigger: the padded t0 and distance fields read once, as wide as
    the widest radius any coastal cell latches at, five fields of every
    cell read and three written, and the ring additions of the tiles
    holding a coastal cell."""
    h, w = radii.shape
    nn = int(radii.max()) if radii.numel() else 0
    _, _, adds = ring_work(radii)
    return 4 * 2 * (h + 2 * nn) * (w + 2 * nn) + 4 * 8 * h * w, adds


def b3_work(h: int, w: int, k: int, reach: int):
    """``(bytes, operations)`` of one call of B3, the fused coast distance:
    the k-padded coast field and the three tables read once, the distance
    parameter written once; a comparison and a select per padded cell for
    pass 1, and a multiply, an add and a minimum on each of the 2k+1 taps
    of the ``reach`` outputs whose window holds a coast cell."""
    nwin = 2 * k + 1
    return (4 * ((h + 2 * k) * (w + 2 * k) + h * w + (2 * h + w) * nwin),
            2 * (h + 2 * k) * w + 3 * nwin * reach)
