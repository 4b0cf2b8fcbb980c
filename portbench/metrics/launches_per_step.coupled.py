"""launches_per_step.coupled (layer ``coupling``): the device's kernels,
copies and fills in the window a step, all of which the coupled step
enqueues.  Moves ``coupled_step_ms``."""
from portbench import readers


def read(run):
    return readers.launches_per_step(run)
