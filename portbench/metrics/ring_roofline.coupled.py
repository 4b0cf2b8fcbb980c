"""ring_roofline.coupled (layer ``ops.cuda``, B4): the least time the card
needs for the padded ring search and trigger of the window's steps
(``roofline.b4_work``), as a share of B4's device time.  B4's kernels by
name: the ring kernel of every build, the large build's integral image of
land and the sweep build's passes.  Moves ``coupled_step_ms``."""
from portbench import readers

PATTERN = (r"\b(ring_kernel|land_rows|land_cols|sweep_latch|sweep_catchup|"
           r"sweep_bands|sweep_final)\b")


def read(run):
    return readers.roofline_share(run, "b4", PATTERN)
