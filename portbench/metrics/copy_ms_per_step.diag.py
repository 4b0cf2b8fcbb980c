"""copy_ms_per_step.diag (layer ``api``): device time a step of the
host-to-device and device-to-host copies, which ``api.diag`` makes of its
host arrays in and its outputs out.  Moves ``diag_ms_per_step``."""
from portbench import readers


def read(run):
    return readers.per_step_ms(
        run, lambda n: n.startswith("Memcpy HtoD") or n.startswith(
            "Memcpy DtoH"))
