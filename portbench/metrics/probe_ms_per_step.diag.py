"""probe_ms_per_step.diag (layer ``api``): host milliseconds a step inside
the port's ``api:probe`` spans, the ring-radius probe of each ``api.diag``
call (step 0's distance on the card, its read-back, the radius worked out
on the host).  Moves ``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.span_ms_per_step(run, "api:probe")
