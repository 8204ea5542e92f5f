"""The reduction of a `torch.profiler` trace to what the per-layer readers
and the result's `breakdown` read.

The traced stretch is the span named SPAN that the harness opens around
it; every device operation (kernel, copy, set) inside it counts.  Device
busy time is the union of their intervals.  An idle gap is a stretch of
the span with no device operation running, named by what the host was
doing at its middle: the innermost host operation the profiler recorded
there.
"""
from __future__ import annotations

import bisect

SPAN = "bench.traced"
NO_HOST_OP = "no host op recorded (Python)"


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> dict:
    """Events: (name, is_device, start_us, end_us) tuples.  Returns
    {"window_s", "busy_s", "device": [(name, start, end)], "gaps":
    [(host name, seconds)], "ops"}, times inside the SPAN."""
    spans = [(s, e) for name, dev, s, e in events
             if name == SPAN and not dev]
    if not spans:
        raise ValueError(f"the trace holds no host span {SPAN!r}")
    w0, w1 = spans[0]
    device = [(name, max(s, w0), min(e, w1)) for name, dev, s, e in events
              if dev and name != SPAN and e > w0 and s < w1]
    host = sorted((s, e, name) for name, dev, s, e in events
                  if not dev and name != SPAN and e > w0 and s < w1)
    busy = _union((s, e) for _, s, e in device)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    starts = [h[0] for h in host]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        inner = [h for h in host[:i] if h[1] >= mid]
        name = max(inner)[2] if inner else NO_HOST_OP
        named.append((name, (b - a) * 1e-6))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "device": device, "gaps": named, "ops": len(device)}


def profiler_events(prof):
    """(name, is_device, start_us, end_us) of every event a
    `torch.profiler.profile` recorded."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA,
             e.time_range.start, e.time_range.end) for e in prof.events()]


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each summed by name: [[name, seconds], ...]."""
    def totals(pairs):
        acc = {}
        for name, sec in pairs:
            acc[name] = acc.get(name, 0.0) + sec
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]
    ops = ((name, (e - s) * 1e-6) for name, s, e in red["device"])
    return {"device_ops": totals(ops), "idle_gaps": totals(red["gaps"])}


def kernel_seconds(red: dict, pattern: str) -> tuple[float, int]:
    """(device seconds, launches) of the operations whose name holds
    `pattern`."""
    hits = [(e - s) * 1e-6 for name, s, e in red["device"] if pattern in name]
    return sum(hits), len(hits)
