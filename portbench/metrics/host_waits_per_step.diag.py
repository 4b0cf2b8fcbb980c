"""host_waits_per_step.diag (layer ``models.pipeline``): the port's
``wait:*`` spans in the window a step, each a statement at which the host
waits for the card (a read-back, or a pageable index upload between
launches).  Moves ``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.waits_per_step(run)
