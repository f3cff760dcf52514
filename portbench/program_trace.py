"""The program's own spans and counters (``libdwt_torch.utils.trace``)
over a profiled sub-window, for the per-layer metrics that read them.

The harness's profiled sub-window records no program spans, so the first
reader that asks runs more after it, in the same process: the window's
call on a pool of the same size made from the run's ``--seed``, a short
warm-up, then four sub-windows of ``trace_frames`` frames of the same
closed loop under the profiler, with ``libdwt_torch.utils.trace
.recording()`` closed, open, closed, open; the metrics read the two
recorded ones.  A record
whose trace already carries ``program_spans`` (and ``program_counts``) is
read as it is, without a run.  With no such record and no recorder in the
program, or no card, every reader finds nothing (``None``).

Alongside, :func:`idle_gaps` labels each idle gap of the card by the
innermost program span at its midpoint (the harness's label where none
holds it); the self times come from the program's own
``libdwt_torch.utils.trace.self_ns`` (imported only where there are
spans, so a program without the recorder is never asked).  The run prints
what it found: the ``dispatch`` counter, the labelled gaps, the self
times against the harness's span around each call, and each sub-window's
frame time and idle share (the recorder's cost, read in turns).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import traceback
from bisect import bisect_right
from collections import defaultdict
from typing import Optional

from portbench import tracing

__all__ = ["SubWindow", "ProgramTrace", "program_trace", "idle_gaps", "per_frame_ms",
           "load_seconds"]

CALL = "in the program's call"


@dataclasses.dataclass
class SubWindow:
    """One profiled stretch of the closed loop: whether the recorder was
    open, its frames and host seconds, device records (name, start ns,
    duration ns) and the harness's host spans (kind, start ns, end ns)."""
    recorded: bool
    frames: int
    seconds: float
    records: list
    host_spans: list


@dataclasses.dataclass
class ProgramTrace:
    """The program's spans (name, start ns, end ns, depth) and counters
    {name: {key: n}} over ``frames`` recorded frames, and, where this
    module ran them, the profiled sub-windows they came from."""
    frames: int
    spans: list
    counts: dict
    windows: list = dataclasses.field(default_factory=list)


def _innermost(spans, starts, t: int) -> Optional[str]:
    """The innermost program span holding ``t``: walking back from the last
    span that starts by ``t``, the first that ends after it (spans sorted
    by start and depth); none once a top-level span ends by ``t``."""
    i = bisect_right(starts, t) - 1
    while i >= 0:
        name, _, end, depth = spans[i]
        if t < end:
            return name
        if depth == 0:
            return None
        i -= 1
    return None


def idle_gaps(records, spans, program_spans=None, top: int = 10):
    """[[label, seconds], ...] as :func:`portbench.tracing.idle_gaps`, with
    each gap whose midpoint falls in a program span labelled by the
    innermost one there; without ``program_spans``, that function's
    output."""
    if not program_spans:
        return tracing.idle_gaps(records, spans, top)
    prog = sorted(program_spans, key=lambda s: (s[1], s[3]))
    pstarts = [s[1] for s in prog]
    host = sorted(spans, key=lambda s: s[1])
    hstarts = [s[1] for s in host]
    total = defaultdict(int)
    end, last = None, None
    for name, start, dur in records:
        if end is not None and start > end:
            mid = (start + end) // 2
            where = _innermost(prog, pstarts, mid) or tracing._host_at(host, hstarts, mid)
            total[f"{where}; after {tracing.short_name(last, 60)}"] += start - end
        if end is None or start + dur > end:
            end, last = start + dur, name
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[label, ns / 1e9] for label, ns in ranked]


def per_frame_ms(pt: Optional[ProgramTrace], keep) -> Optional[float]:
    """The self time of the spans whose names ``keep`` accepts, in ms a
    frame; 0.0 where the sub-window held spans but none of these, None
    where it held none."""
    if pt is None or not pt.spans or pt.frames <= 0:
        return None
    from libdwt_torch.utils.trace import self_ns

    own = self_ns(pt.spans)
    return sum(ns for name, ns in own.items() if keep(name)) / 1e6 / pt.frames


def load_seconds() -> Optional[float]:
    """Seconds of the program's one-time ``cuda.build`` and ``cuda.load``
    events in this process (0.0 where there were none); None where the
    program keeps no such events."""
    try:
        from libdwt_torch.utils.trace import once_events
    except ImportError:
        return None
    return sum((s for name, s, _ in once_events() if name in ("cuda.build", "cuda.load")), 0.0)


# ------------------------------------------------------------------ the run

_cache: list = []  # [(run, ProgramTrace or None)]: one run a process


def _seed() -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def program_trace(run) -> Optional[ProgramTrace]:
    """The program's spans and counters over a profiled sub-window of
    ``run`` (a ``harness.RunRecord``): read from its trace where it carries
    them, else measured once, after the harness's own; None where there is
    nothing to read."""
    trace_ = run.trace
    if trace_ is None:
        return None
    if hasattr(trace_, "program_spans"):
        return ProgramTrace(trace_.window.frames, list(trace_.program_spans),
                            dict(getattr(trace_, "program_counts", {})))
    for done, pt in _cache:
        if done is run:
            return pt
    pt = None
    try:
        pt = _measure(run)
    except Exception:  # a reader must not end the run: report and read nothing
        print(f"portbench: the program's sub-window failed:\n{traceback.format_exc()}",
              file=sys.stderr)
    _cache[:] = [(run, pt)]
    return pt


def _measure(run, device: str = "cuda") -> Optional[ProgramTrace]:
    """Four profiled sub-windows on ``device``, the recorder closed, open,
    closed, open (its cost read in turns); the spans and counters of the
    two recorded ones.  'cpu' rehearses it with the profiler's host
    activity.  None without the recorder, or without the card."""
    try:
        from libdwt_torch.utils.trace import recording
    except ImportError:
        return None
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    on_cuda = device == "cuda"
    if on_cuda and (run.device_name == "cpu" or not torch.cuda.is_available()):
        return None
    cfg, mix = run.cfg, run.mix
    direction = mix["direction"]
    pool = harness.make_pool(cfg, mix, _seed(), device)
    inputs = list(pool) if direction == "encode" else harness.decode_inputs(cfg, pool)
    del pool
    program = harness.Program(cfg, direction)
    harness.closed_loop(program, inputs, mix["in_flight"], device,
                        frames=mix["in_flight"] + 1)
    activity = ProfilerActivity.CUDA if on_cuda else ProfilerActivity.CPU
    pt = ProgramTrace(0, [], {})
    for recorded in (False, True, False, True):
        host_spans = []
        if on_cuda:
            torch.cuda.synchronize()
        with recording() if recorded else contextlib.nullcontext() as rec:
            with profile(activities=[activity]) as prof:
                window = harness.closed_loop(program, inputs, mix["in_flight"], device,
                                             frames=mix["trace_frames"], spans=host_spans)
        pt.windows.append(SubWindow(recorded, window.frames, window.seconds,
                                    tracing.device_records(prof), host_spans))
        if recorded:
            pt.frames += window.frames
            pt.spans += rec.spans
            for name, slot in rec.counts.items():
                mine = pt.counts.setdefault(name, {})
                for key, n in slot.items():
                    mine[key] = mine.get(key, 0) + n
    _report(pt)
    return pt


def _idle_share(records, seconds: float) -> Optional[float]:
    if not records or seconds <= 0:
        return None
    return 100.0 * (1.0 - tracing.union_ns(records) / 1e9 / seconds)


def _report(pt: ProgramTrace) -> None:
    """Lines on standard output, before the result's."""
    from libdwt_torch.utils.trace import once_events, self_ns

    def out(line):
        print(line, flush=True)

    on = [w for w in pt.windows if w.recorded]
    dispatch = {"|".join(map(str, k)): n for k, n in pt.counts.get("dispatch", {}).items()}
    out(f"program dispatch counter over {pt.frames} frames: {dispatch}")
    out(f"program spans: {len(pt.spans) / pt.frames:.2f} a frame, "
        f"{sum(dispatch.values()) / pt.frames:.2f} dispatch counts a frame")
    own = self_ns(pt.spans)
    out(f"program spans, self time a frame (ms): "
        f"{ {k: round(v / 1e6 / pt.frames, 6) for k, v in sorted(own.items())} }")
    span_s = sum(own.values()) / 1e9
    call_s = sum(e - s for w in on for kind, s, e in w.host_spans if kind == CALL) / 1e9
    if call_s > 0:
        out(f"program spans: {span_s:.6f} s of self time over the recorded frames, "
            f"{100 * span_s / call_s:.2f}% of the harness's '{CALL}' spans ({call_s:.6f} s)")
    gaps = defaultdict(float)
    for w in on:
        for label, sec in idle_gaps(w.records, w.host_spans, pt.spans, top=10**6):
            gaps[label] += sec
    out(f"program idle gaps: {sorted(gaps.items(), key=lambda kv: -kv[1])[:12]}")
    inside = {k: v for k, v in gaps.items()
              if not k.startswith(("harness between calls", "waiting on"))}
    if inside:
        total = sum(inside.values())
        bare = sum(v for k, v in inside.items() if k.startswith(CALL))
        out(f"program idle inside the calls: {total:.6f} s, "
            f"{100 * (total - bare) / total:.2f}% under a program span's label")
    for w in pt.windows:
        idle = _idle_share(w.records, w.seconds)
        out(f"recorder {'on ' if w.recorded else 'off'}: {w.frames} frames, "
            f"{1e3 * w.seconds / max(w.frames, 1):.6f} ms a frame, device idle "
            f"{idle if idle is None else round(idle, 3)}%")
    out(f"program one-time events: {[(n, round(s, 6), a) for n, s, a in once_events()]}")
