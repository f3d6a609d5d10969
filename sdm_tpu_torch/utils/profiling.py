"""Step-rate timing for the training loop (the port's own copy of
sdm_tpu/utils/profiling.py::StepTimer).

Rates come from the wall time between host-synced losses, so they are right
under asynchronous launches. sdm_tpu's `trace(logdir)` (config
"profile_trace_dir", a jax.profiler capture) has no counterpart yet: a
torch.profiler port is ROADMAP Queue 1 item 10, and the trainers refuse the
key until then.
"""

from __future__ import annotations

import time


class StepTimer:
    """Running steps/sec over a sliding window, and the last
    `max_intervals` per-step wall-time intervals."""

    def __init__(self, window: int = 50, max_intervals: int = 10_000):
        self.window = window
        self.max_intervals = max_intervals
        self._times = []
        self._intervals = []

    def tick(self) -> None:
        now = time.perf_counter()
        if self._times:
            self._intervals.append(now - self._times[-1])
            if len(self._intervals) > self.max_intervals:
                self._intervals.pop(0)
        self._times.append(now)
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return float("nan")
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else float("nan")

    def intervals(self) -> list:
        """Per-step wall-time intervals (seconds), oldest first. The first
        spans from the first host-synced loss to the second, so it excludes
        the first step."""
        return list(self._intervals)
