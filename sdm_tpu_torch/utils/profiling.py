"""Profiling for the training loop (port of sdm_tpu/utils/profiling.py):

  - `trace(logdir)`: a torch.profiler capture of what runs inside (config
    "profile_trace_dir"; sdm_tpu's is a jax.profiler capture), one Chrome
    trace file per rank, viewable in Perfetto or chrome://tracing;
  - `StepTimer`: steps/sec from the wall time between host-synced losses,
    so rates are right under asynchronous launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: Optional[str], device_type: str = "cpu"):
    """Profile what runs inside into `logdir`/trace_rank<r>.json (r: this
    process's rank): CPU activity, and CUDA kernels when `device_type` is
    "cuda". A no-op when logdir is empty or None."""
    if not logdir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    rank = dist.get_rank() if dist.is_initialized() else 0
    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace_rank{rank}.json"))


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
