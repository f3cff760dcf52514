"""Arithmetic on the profiler's device records and the harness's host spans.

Device records come from ``torch.profiler`` (CUPTI activity records:
kernels, copies, fills) as (name, start ns, duration ns).  The device's
busy time is the union of their intervals, not their sum.  Host spans
are the harness's own (kind, start ns, end ns) on ``time.time_ns()``, the
clock that the profiler's records are stamped in.
"""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

__all__ = ["device_records", "union_ns", "short_name", "device_ops", "idle_gaps"]


def device_records(prof):
    """(name, start_ns, duration_ns) of every device record of a finished
    ``torch.profiler.profile``, sorted by start."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = 1000 * e.start_us(), 1000 * e.duration_us()
        out.append((e.name(), int(start), int(dur)))
    out.sort(key=lambda r: r[1])
    return out


def union_ns(records) -> int:
    """Nanoseconds in which at least one record was running."""
    busy, end = 0, None
    for _, start, dur in sorted(records, key=lambda r: r[1]):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def short_name(name: str, width: int = 100) -> str:
    """A device record's name without ``void``, anonymous namespaces and
    its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:width]


def device_ops(records, top: int = 10):
    """[[name, seconds], ...]: the names that took most device time."""
    total = defaultdict(int)
    for name, _, dur in records:
        total[short_name(name)] += dur
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def _host_at(spans, starts, t: int) -> str:
    """The kind of the (non-overlapping, sorted) host span holding ``t``."""
    i = bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][2]:
        return spans[i][0]
    return "harness between calls"


def idle_gaps(records, spans, top: int = 10):
    """[[label, seconds], ...]: idle time between device records, summed by
    what the host was doing at the gap's midpoint and by the record that
    the device had just finished; the largest first."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    total = defaultdict(int)
    end, last = None, None
    for name, start, dur in records:
        if end is not None and start > end:
            label = f"{_host_at(spans, starts, (start + end) // 2)}; after {short_name(last, 60)}"
            total[label] += start - end
        if end is None or start + dur > end:
            end, last = start + dur, name
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[label, ns / 1e9] for label, ns in ranked]
