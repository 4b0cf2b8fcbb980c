"""host_waits_per_step.coupled (layer ``coupling``): the port's ``wait:*``
spans in the window a step, each a statement at which the host waits for
the card (a read-back, or a pageable index upload between launches).
Moves ``coupled_step_ms``."""
from portbench import spans


def read(run):
    return spans.waits_per_step(run)
