"""A cell's run loads neither JAX nor the JAX package, compared by whole
top-level module names: the port's name begins with the JAX package's."""
from __future__ import annotations

import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "seabreeze_param_tpu_torch_x", sys)
    assert "seabreeze_param_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seabreeze_param_tpu.api", sys)
    assert "seabreeze_param_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests import helpers\n"
        "from portbench import harness\n"
        "for cell in helpers.CELLS:\n"
        "    helpers.run(cell, seconds=0.05)\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """``run.py`` exits non-zero and prints no result where the cell's
    cards are missing (here: no CUDA at all)."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "era5_025.diag_ice", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
