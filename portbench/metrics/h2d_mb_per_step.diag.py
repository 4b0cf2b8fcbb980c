"""h2d_mb_per_step.diag (layer ``api``): megabytes a step of host arrays
that the port moved to the card in the window, its ``h2d_bytes`` counter
(every field and state array of each ``api.diag`` call).  Moves
``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.counter_per_step(run, "h2d_bytes", 1e6)
