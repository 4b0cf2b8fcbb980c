"""Sub-grid-orography sigmoid weighting (reference ``sigmoid``,
``seabreeze_diag_python.f90:287-311``); counterpart of
``seabreeze_param_tpu.ops.orography``:

    mean = sum(std) / N
    var  = sum((std - mean)^2)
    s    = 2 / sqrt(var / N)
    r    = (max(std) - min(std)) / 4
    w    = 1 / (1 + exp(-s * (std - r)))

The four statistics are global.  :func:`sigmoid_weight_shards` takes them
over a mesh's shard list: the per-shard partial sums, counts, maxima and
minima are combined first (the JAX package's psum/pmax/pmin), then the sum
of squares about the global mean; ``valid_mask`` leaves the lat-padding
rows of a decomposed grid out of them.  Shards may lie on several devices
(the groups of a mesh over several cards): each shard's partials are
taken on its own device and moved to the first shard's, where they are
reduced in shard order, so the weights equal those of the same shards on
one device, bit for bit.  In a multi-process run each process holds some
of the shards, and its partials are gathered over every process before
they are reduced, in global shard order with the same ops, so the weights
equal one process's on the same mesh.
"""
from __future__ import annotations

import torch


def sigmoid_weight(std_field, *, valid_mask=None):
    """Logistic weight of a (nlat, nlon) float32 std-orography tensor;
    ``valid_mask`` (broadcastable bool) leaves cells out of the
    statistics."""
    if valid_mask is not None:
        return sigmoid_weight_shards([std_field], [valid_mask])[0]
    a = std_field
    n = float(a.numel())
    mean = a.sum() / n
    var = ((a - mean) ** 2).sum()
    s = 2.0 / torch.sqrt(var / n)
    r = (a.max() - a.min()) / 4.0
    return 1.0 / (1.0 + torch.exp(-s * (a - r)))


def sigmoid_weight_shards(stds, valid_masks, gather=None):
    """:func:`sigmoid_weight` of the field that the shards ``stds`` make up
    together, one weight block per shard; ``valid_masks[i]`` (bool,
    broadcastable to shard i) marks the cells the statistics count.
    ``gather`` — in a multi-process run, a function that concatenates an
    (n, c) tensor of this process's per-shard partials with every other
    process's, in global shard order (``parallel.distributed.
    all_gather_cat``); None: these shards are the whole field."""
    dev = stds[0].device

    def stack(parts):
        """The per-shard partials, in shard order, on ``dev``."""
        return torch.stack([x.to(dev) for x in parts])

    vms = [torch.broadcast_to(vm, a.shape) for a, vm in zip(stds, valid_masks)]
    counts = stack([vm.sum() for vm in vms])
    sums = stack([torch.where(vm, a, 0.0).sum() for a, vm in zip(stds, vms)])
    maxes = stack([torch.where(vm, a, -torch.inf).max()
                   for a, vm in zip(stds, vms)])
    mins = stack([torch.where(vm, a, torch.inf).min()
                  for a, vm in zip(stds, vms)])
    if gather is not None:
        # float64 carries the float32 partials and the counts exactly
        part = gather(torch.stack([counts.double(), sums.double(),
                                   maxes.double(), mins.double()], 1))
        counts = part[:, 0].long()
        sums, maxes, mins = (part[:, i].float().contiguous()
                             for i in (1, 2, 3))
    n = float(int(counts.sum()))
    total, amax, amin = sums.sum(), maxes.max(), mins.min()
    mean = total / n
    sq = stack([torch.where(vm, (a - mean.to(a.device)) ** 2, 0.0).sum()
                for a, vm in zip(stds, vms)])
    if gather is not None:
        sq = gather(sq.double()[:, None])[:, 0].float().contiguous()
    var = sq.sum()
    s = 2.0 / torch.sqrt(var / n)
    r = (amax - amin) / 4.0
    return [1.0 / (1.0 + torch.exp(-s.to(a.device) * (a - r.to(a.device))))
            for a in stds]
