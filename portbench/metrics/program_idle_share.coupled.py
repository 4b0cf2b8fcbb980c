"""program_idle_share.coupled (layer ``device``): the share of the traced
window in which a span of the port is open on the host and no event runs
on the card: the card's idle time that belongs to the program, not to the
benchmark's loop.  Moves ``coupled_step_ms``."""
from portbench import spans


def read(run):
    return spans.program_idle_share(run)
