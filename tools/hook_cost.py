"""What a span of the port costs the host: one ``tracer.hook`` of the
process-global tracer with no profiler running (the shared no-op
context), the same label as an ungated ``torch.profiler.record_function``
(what the coupling's ranges cost before they were gated), and a hook under
a running profiler (the traced runs' cost), each a mean over many calls.

    python3 tools/hook_cost.py [--calls N]

Prints one JSON line of microseconds a call, with the host's Python and
torch versions and, where there is a card, its name.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from seabreeze_param_tpu_torch.utils.tracing import tracer  # noqa: E402


def per_call_us(make, calls):
    """Mean microseconds of entering and leaving ``make()``'s context."""
    for _ in range(1000):
        with make():
            pass
    t0 = time.perf_counter()
    for _ in range(calls):
        with make():
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200000)
    args = ap.parse_args(argv)
    label = "coupling:seabreeze_diag"
    out = {"gated_off_us": per_call_us(lambda: tracer.hook(label),
                                       args.calls),
           "record_function_us": per_call_us(
               lambda: torch.profiler.record_function(label), args.calls)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["gated_profiled_us"] = per_call_us(lambda: tracer.hook(label),
                                               args.calls // 10)
    out.update(python=platform.python_version(), torch=torch.__version__,
               device=(torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
