"""device_idle_share.coupled (layer ``device``): the share of the traced
window in which no operation ran on the card, 1 - the union of the device
events' intervals over the window.  Moves ``coupled_step_ms``."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
