"""A traced sub-window of a run: torch.profiler over the card, reduced to
what the per-layer metrics read.

`Tracer.start()` and `stop()` each synchronise the card first, so every
kernel launched between them runs inside the trace, and read the port's
launch counters, so the counts cover the same work. The summary holds the
device kernels ([name, start, duration] in seconds), the busy time (the
union of the kernel intervals), the window's length on the host's clock,
the kernels' time by family and the idle gaps named by the host-side
operation that overlapped them most.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

# Kernel families by name fragment, first match wins (the port's streaming
# backward passes before its other streaming kernels, those before the
# whole-S attention, the port's kernels and cuDNN's convolutions before
# cuBLAS's GEMMs).
FAMILIES = (("adagn_", "adagn (port)"),
            ("dv_pass", "streaming dV (port)"),
            ("dk_pass", "streaming dK (port)"),
            ("dq_pass", "streaming dQ (port)"),
            ("stream", "streaming attention (port)"),
            ("attn_", "attention (port)"),
            ("linear_", "linear (port)"), ("fprop", "conv (cuDNN)"),
            ("dgrad", "conv (cuDNN)"), ("wgrad", "conv (cuDNN)"),
            ("conv", "conv (cuDNN)"), ("implicit", "conv (cuDNN)"),
            ("nccl", "nccl"),
            ("gemm", "matmul (cuBLAS)"), ("multi_tensor", "Adam (torch)"),
            ("adam", "Adam (torch)"))
OTHER = "other (elementwise, copies)"
PORT_FAMILIES = {f for _, f in FAMILIES if f.endswith("(port)")}
CONV = "conv (cuDNN)"


def family(name: str) -> str:
    low = name.lower()
    return next((f for frag, f in FAMILIES if frag in low), OTHER)


def union_seconds(intervals: List[tuple]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[tuple], lo: float, hi: float) -> List[tuple]:
    """The gaps [s, e) in [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def name_gaps(gaps: List[tuple], host: List[tuple]) -> Dict[str, float]:
    """Idle seconds by the host operation ([name, start, end]) that
    overlapped each gap most. One sweep over both in time order: only the
    operations open at a gap are looked at."""
    host = sorted(host, key=lambda h: h[1])
    out: Dict[str, float] = {}
    active, nxt = [], 0
    for s, e in sorted(gaps):
        while nxt < len(host) and host[nxt][1] < e:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[2] > s]
        best, best_ov = "host (no operation recorded)", 0.0
        for name, hs, he in active:
            ov = min(e, he) - max(s, hs)
            if ov > best_ov:
                best, best_ov = name, ov
        out[best] = out.get(best, 0.0) + (e - s)
    return out


class Summary:
    def __init__(self, kernels, host, window_s, counts):
        self.kernels = kernels            # [(name, start_s, dur_s)]
        self.window_s = window_s
        self.counts = counts              # launch counters' deltas
        if kernels:
            lo = min(k[1] for k in kernels)
            intervals = [(k[1], k[1] + k[2]) for k in kernels]
            self.busy_s = union_seconds(intervals)
            gaps = idle_gaps(intervals, lo, max(e for _, e in intervals))
            self.gaps = name_gaps(gaps, host)
        else:
            self.busy_s, self.gaps = 0.0, {}
        self.families: Dict[str, float] = {}
        self.by_name: Dict[str, float] = {}
        for name, _, dur in kernels:
            fam = family(name)
            self.families[fam] = self.families.get(fam, 0.0) + dur
            self.by_name[name] = self.by_name.get(name, 0.0) + dur

    def device_seconds(self, fams=None) -> float:
        return sum(v for k, v in self.families.items()
                   if fams is None or k in fams)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _events(prof):
    """([(kernel name, start s, duration s)], [(host op, start s, end s)])
    from the profiler's raw events."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        dur = e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), start, dur))
        elif e.device_type() == DeviceType.CPU and dur > 0:
            host.append((e.name(), start, start + dur))
    return kernels, host


class Tracer:
    """Profiles the card from start() to stop(), both called on the thread
    that launches the work; summary() reduces the trace afterwards.
    `read_counts` returns the launch counters."""

    def __init__(self, read_counts: Callable[[], Dict[str, int]]):
        self.read_counts = read_counts
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.counts0 = self.read_counts()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.window = time.perf_counter() - self.t0
        counts = self.read_counts()
        self.delta = {k: counts[k] - self.counts0.get(k, 0) for k in counts}
        self.prof.__exit__(None, None, None)

    def summary(self) -> Summary:
        kernels, host = _events(self.prof)
        self.prof = None
        return Summary(kernels, host, self.window, self.delta)


class OnThread:
    """Starts and stops a Tracer on the thread that calls `obj.method`
    (a server's device worker), at its next call after start() or stop()
    is asked for from another thread."""

    def __init__(self, tracer: Tracer, obj, method: str):
        self.tracer, self.asked = tracer, None
        self.done = threading.Event()
        inner = getattr(obj, method)

        def call(*args, **kwargs):
            if self.asked is not None:
                getattr(self.tracer, self.asked)()
                self.asked = None
                self.done.set()
            return inner(*args, **kwargs)
        setattr(obj, method, call)

    def ask(self, what: str, timeout: float) -> bool:
        self.done.clear()
        self.asked = what
        return self.done.wait(timeout)
