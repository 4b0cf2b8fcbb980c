"""staged_mb_per_step.diag (layer ``api``): megabytes a step that the port
moved through ``api.diag``'s staging slots in the window, both ways, its
``staged_bytes`` counter (every field and state array in, each step's
``sb_con`` and the state out).  Reads None where the port keeps no such
counter.  Moves ``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.counter_per_step(run, "staged_bytes", 1e6)
