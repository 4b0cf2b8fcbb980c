"""ring_roofline.diag (layer ``ops.cuda``, B1): the least time the card
needs for the stacked ring search and trigger of the window's steps
(``roofline.b1_work``), as a share of B1's device time.  B1's kernels by
name: the ring kernel of every build, the large build's integral image of
land and the sweep build's passes.  Moves ``diag_ms_per_step``."""
from portbench import readers

PATTERN = (r"\b(ring_kernel|land_rows|land_cols|sweep_latch|sweep_catchup|"
           r"sweep_bands|sweep_final)\b")


def read(run):
    return readers.roofline_share(run, "b1", PATTERN)
