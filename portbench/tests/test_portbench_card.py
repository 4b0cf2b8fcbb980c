"""A cell on the card through ``run.py``: one short run, ``correct``
true and the end-to-end metrics reported.  Needs an NVIDIA GPU."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "era5_025.diag_ice", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=str(harness.ROOT), capture_output=True,
        text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert {"setup_s", "diag_ms_per_step"} <= set(result["metrics"])
