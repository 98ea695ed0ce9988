"""What one run measured, as the metric readers see it."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    cell: object                 # harness.spec.Cell
    ctx: object                  # harness.driving.Context
    setup_s: float
    window_s: float
    jobs: list                   # harness.driving.Job, in order
    counters: dict = field(default_factory=dict)   # harness.counters.diff
    trace: object = None         # harness.trace.DeviceTrace, --trace 1
    peak_bytes: int | None = None
