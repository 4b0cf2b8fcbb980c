"""Per-step metrics / observability; counterpart of
``seabreeze_param_tpu.utils.metrics``.

The reference's observability is stdout progress lines
(``test_run.py:24-25``) and CF metadata on outputs.  Here: a structured
per-step metrics recorder — throughput (grid-points/s), wall time — emitted
as JSON lines with the JAX package's keys, and the card's memory use from
``torch.cuda.memory_stats``.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StepMetrics:
    """Rolling throughput recorder for a step loop.

    >>> m = StepMetrics(grid_points=nlat * nlon)
    >>> with m.step():          # around each (batch of) device step(s)
    ...     run_one_step()
    >>> m.emit()                # one JSON line to the stream
    """

    grid_points: int
    stream: object = None
    steps: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    extras: dict = field(default_factory=dict)

    def step(self):
        return _Timed(self)

    def record(self, seconds: float, n_steps: int = 1):
        self.steps += n_steps
        self.total_s += seconds
        self.last_s = seconds / max(1, n_steps)

    def add(self, **kv):
        """Attach extra metric fields (halo bytes, active cells, ...)."""
        self.extras.update(kv)

    @property
    def points_per_s(self) -> float:
        return self.grid_points * self.steps / self.total_s \
            if self.total_s else 0.0

    def as_dict(self) -> dict:
        return dict(steps=self.steps, step_ms=round(self.last_s * 1e3, 3),
                    mean_step_ms=round(
                        self.total_s / max(1, self.steps) * 1e3, 3),
                    grid_points=self.grid_points,
                    points_per_s=round(self.points_per_s, 1), **self.extras)

    def emit(self):
        out = self.stream if self.stream is not None else sys.stderr
        out.write(json.dumps(self.as_dict()) + "\n")
        # flush per line: metrics exist for post-mortems, which are exactly
        # the runs that die without reaching a clean close()
        out.flush()


class _Timed:
    def __init__(self, m: StepMetrics):
        self.m = m

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.record(time.perf_counter() - self.t0)


def device_memory_stats() -> dict:
    """Bytes allocated by torch now and at peak, per visible card:
    ``{"0": {"bytes_in_use": ..., "peak_bytes_in_use": ...}, ...}`` (the
    JAX package's keys); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0))}
    return out
