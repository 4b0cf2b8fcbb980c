"""distance_roofline.diag (layer ``ops.cuda``, B3): the least time the
card needs for the window's fused coast distances (``roofline.b3_work``:
every step's and the probe's), as a share of B3's device time.  B3's
kernels by name: the staged kernel and the large build's three.  Moves
``diag_ms_per_step``."""
from portbench import readers

PATTERN = (r"\b(min_haversine_kernel|pieces_kernel|pass1_rows_kernel|"
           r"pass2_pruned_kernel)\b")


def read(run):
    return readers.roofline_share(run, "b3", PATTERN)
