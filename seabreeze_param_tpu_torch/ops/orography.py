"""Sub-grid-orography sigmoid weighting (reference ``sigmoid``,
``seabreeze_diag_python.f90:287-311``); counterpart of
``seabreeze_param_tpu.ops.orography``, single-device form:

    mean = sum(std) / N
    var  = sum((std - mean)^2)
    s    = 2 / sqrt(var / N)
    r    = (max(std) - min(std)) / 4
    w    = 1 / (1 + exp(-s * (std - r)))
"""
from __future__ import annotations

import torch


def sigmoid_weight(std_field):
    """Logistic weight of a (nlat, nlon) float32 std-orography tensor."""
    a = std_field
    n = float(a.numel())
    mean = a.sum() / n
    var = ((a - mean) ** 2).sum()
    s = 2.0 / torch.sqrt(var / n)
    r = (a.max() - a.min()) / 4.0
    return 1.0 / (1.0 + torch.exp(-s * (a - r)))
