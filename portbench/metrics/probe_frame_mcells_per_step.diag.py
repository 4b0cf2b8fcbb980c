"""probe_frame_mcells_per_step.diag (layer ``api``): millions of cells a
step of the frames the ring-radius probe's host transforms walked in the
window, the port's ``probe_frame_cells`` counter ((nlat + 2 cap) x (nlon +
2 cap) a pass).  Moves ``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.counter_per_step(run, "probe_frame_cells", 1e6)
