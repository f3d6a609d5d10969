"""The arithmetic the per-layer metrics share: each reader in metrics/
picks one of these with its own arguments. A reader returns None where its
window holds nothing to read."""

from __future__ import annotations

from gpubench.counters import KERNEL_FUNCTIONS
from gpubench.peaks import PEAK_BF16, least_seconds
from gpubench.trace import CONV, PORT_FAMILIES


def per_call_ms(trace, seconds: float, calls_key: str):
    calls = trace.counts.get(calls_key, 0) if trace else 0
    return seconds * 1e3 / calls if calls > 0 else None


def device_ms_per(trace, calls_key: str):
    """Device time of every kernel in the trace per counted call."""
    if trace is None:
        return None
    return per_call_ms(trace, trace.device_seconds(), calls_key)


def conv_ms_per(trace, calls_key: str):
    """cuDNN convolution kernels' device time per counted call."""
    if trace is None or trace.families.get(CONV, 0.0) <= 0:
        return None
    return per_call_ms(trace, trace.families[CONV], calls_key)


def idle_share(trace):
    """Per cent of the traced window with no kernel running."""
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernels_roofline(record: dict, trace):
    """Per cent: the least time of the work of the port's kernel functions
    called in the trace (their launch counts times the mean work of a call
    at this cell's shapes) over those kernels' device time."""
    if trace is None:
        return None
    device = trace.device_seconds(PORT_FAMILIES)
    least = 0.0
    for fn in KERNEL_FUNCTIONS:
        work = record["kernel_work"].get(fn)
        calls = trace.counts.get(fn, 0)
        if work and calls > 0:
            least += calls / len(work) * sum(least_seconds(o, b)
                                             for o, b in work)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def mfu(flops: float, seconds: float, chips: int = 1):
    """Per cent of the card's bf16 peak that `flops` in `seconds` is."""
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / seconds / (PEAK_BF16 * chips)
