"""The ring radius NN that ``api.diag`` runs at on a regular regional grid.

For each world, prints the distance radius k, the static bound
``TriggerPipeline.nn_max`` (k + 2 + margin) and the NN that ``diag``
takes (``ops.ring_search.ring_bound``): the larger of that bound and the
radius probed on the first step's distance field plus the margin.  The
ring kernels (``csrc/ring_trigger.cu``) refuse an NN above their widest
radius, so this says whether ``diag`` runs on the card at a given spacing.
The fields are ``bench.make_world``'s (seed 3), as in ``chip_smoke.py``.
Runs on the CPU:

    python tools/ring_nn.py                       # the worlds below
    python tools/ring_nn.py --nlat 1024 --nlon 1024 --spacing 0.009 --lat0 54
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import make_world  # noqa: E402
from seabreeze_param_tpu_torch.core.grid import Grid  # noqa: E402
from seabreeze_param_tpu_torch.core.params import Params  # noqa: E402
from seabreeze_param_tpu_torch.models.pipeline import (  # noqa: E402
    TriggerPipeline)
from seabreeze_param_tpu_torch.ops.ring_search import ring_bound  # noqa: E402

#: (nlat, nlon, spacing in degrees, northern edge in degrees N): the
#: 1.5 km world of chip_smoke.py's fine phase, a 1 km world at 45-54 N,
#: and the world of tests/test_torch_large_nn.py.
WORLDS = ((1024, 1024, 0.015, 55.0), (1024, 1024, 0.009, 54.0),
          (80, 96, 0.015, 1.2))


def diag_nn(nlat: int, nlon: int, spacing: float, lat0: float):
    """(k, nn_max, NN) of an nlat x nlon world ``spacing`` degrees apart
    from ``lat0`` southward."""
    grid = Grid.regular(nlat, nlon, lat0=lat0,
                        lat1=lat0 - (nlat - 1) * spacing, lon0=0.0,
                        lon1=nlon * spacing)
    lsm, *_, ci = make_world(nlat, nlon, 1, 1, seed=3)
    pipe = TriggerPipeline(grid, Params(), device="cpu", use_kernels=False)
    cd0 = pipe.distance_field(torch.as_tensor(lsm),
                              torch.as_tensor(ci[0])).numpy()
    return pipe.k, pipe.nn_max, ring_bound(cd0, pipe.k, pipe.params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, help="rows")
    ap.add_argument("--nlon", type=int, help="columns")
    ap.add_argument("--spacing", type=float, help="degrees between cells")
    ap.add_argument("--lat0", type=float, help="northern edge, degrees N")
    a = ap.parse_args(argv)
    worlds = WORLDS if a.nlat is None else (
        (a.nlat, a.nlon, a.spacing, a.lat0),)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for nlat, nlon, d, lat0 in worlds:
        k, static, nn = diag_nn(nlat, nlon, d, lat0)
        print(f"{nlat} x {nlon} at {d} deg, {lat0} to "
              f"{lat0 - (nlat - 1) * d:.3f} N: k = {k}, nn_max = {static}, "
              f"diag's NN = {nn}", flush=True)


if __name__ == "__main__":
    main()
