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
rows of a decomposed grid out of them.
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


def sigmoid_weight_shards(stds, valid_masks):
    """:func:`sigmoid_weight` of the field that the shards ``stds`` make up
    together, one weight block per shard; ``valid_masks[i]`` (bool,
    broadcastable to shard i) marks the cells the statistics count."""
    vms = [torch.broadcast_to(vm, a.shape) for a, vm in zip(stds, valid_masks)]
    n = float(sum(int(vm.sum()) for vm in vms))
    total = torch.stack([torch.where(vm, a, 0.0).sum()
                         for a, vm in zip(stds, vms)]).sum()
    amax = torch.stack([torch.where(vm, a, -torch.inf).max()
                        for a, vm in zip(stds, vms)]).max()
    amin = torch.stack([torch.where(vm, a, torch.inf).min()
                        for a, vm in zip(stds, vms)]).min()
    mean = total / n
    var = torch.stack([torch.where(vm, (a - mean) ** 2, 0.0).sum()
                       for a, vm in zip(stds, vms)]).sum()
    s = 2.0 / torch.sqrt(var / n)
    r = (amax - amin) / 4.0
    return [1.0 / (1.0 + torch.exp(-s * (a - r))) for a in stds]
