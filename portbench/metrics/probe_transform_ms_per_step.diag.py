"""probe_transform_ms_per_step.diag (layer ``api``): host milliseconds a
step inside the port's ``probe:transform`` spans, the ring-radius probe's
chamfer transforms on the host (``api.ring_radius``, each pass over a frame
padded by the probe's cap on every side), the part of ``api:probe`` that
grows with the distance's radius k.  Moves ``diag_ms_per_step``."""
from portbench import spans


def read(run):
    return spans.span_ms_per_step(run, "probe:transform")
