"""torch_ops_ms_per_step.diag (layer ``ops``): device time a step of
PyTorch's own kernels and fills (mask, Sobel, pads, t0, the wind level,
the sigmoid, the distance tables' selects): every device event that is
neither a copy nor a kernel of the port's ``csrc/``.  Moves
``diag_ms_per_step``."""
from portbench import readers


def read(run):
    return readers.per_step_ms(
        run, lambda n: not n.startswith(readers.COPY_PREFIX)
        and not readers.CSRC.search(n))
