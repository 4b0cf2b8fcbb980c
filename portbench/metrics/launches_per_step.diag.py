"""launches_per_step.diag (layer ``models.pipeline``): the device's
kernels, copies and fills in the window a step, all of which the host's
step loop enqueues.  Moves ``diag_ms_per_step``."""
from portbench import readers


def read(run):
    return readers.launches_per_step(run)
