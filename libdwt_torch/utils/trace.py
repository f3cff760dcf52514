"""The port's host-side recorder: spans, counters and one-time events.

Code of the port marks where its host time goes with ``span(name)`` (a
context manager) and what it chose with ``count(name, key)``.  Both report
to the innermost open recorder, which a caller opens with
:func:`recording`; with none open (the default) a span site costs one
truthiness check and returns the one shared no-op context manager, and a
count site returns at once.  There is no environment variable and no
global switch.

A span is (name, start ns, end ns, depth) on ``time.time_ns()``, the clock
that ``torch.profiler``'s device records are stamped in, so the program's
spans and the card's records share one time axis; ``depth`` is the number
of the recorder's spans open around it.  :func:`self_ns` sums each name's
self time: its spans' durations less their children's.

``once(name, seconds, **attrs)`` keeps a one-time event (the kernels'
build, a library load) whether a recorder is open or not;
:func:`once_events` returns them.

The collective counts of :mod:`libdwt_torch.parallel.comm_stats` go
through the same recorder.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

__all__ = ["Recorder", "recording", "enabled", "span", "count", "once",
           "once_events", "self_ns"]


class Recorder:
    """What one :func:`recording` block saw: ``spans`` as (name, start_ns,
    end_ns, depth) in the order they closed, ``counts`` as {name: {key:
    n}}."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, int, int, int]] = []
        self.counts: Dict[str, Dict[object, int]] = {}
        self.depth = 0


#: the recorders open now (innermost last)
_active: List[Recorder] = []
#: one-time events, kept with or without a recorder: (name, seconds, attrs)
_once: List[Tuple[str, float, dict]] = []


class _Off:
    """The span of a site with no recorder open: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "start", "depth")

    def __init__(self, rec: Recorder, name: str) -> None:
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.depth = rec.depth
        rec.depth += 1
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        rec = self.rec
        rec.depth -= 1
        rec.spans.append((self.name, self.start, end, self.depth))
        return None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Open a recorder for the block; the spans and counts of the code it
    runs (those of recorders opened inside it excepted) land in it."""
    rec = Recorder()
    _active.append(rec)
    try:
        yield rec
    finally:
        _active.pop()


def enabled() -> bool:
    """Whether a recorder is open (a site whose key costs work to build
    asks first)."""
    return bool(_active)


def span(name: str):
    """A context manager timing its block as ``name`` in the innermost open
    recorder; :data:`OFF` when none is open."""
    if not _active:
        return OFF
    return _Span(_active[-1], name)


def count(name: str, key, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under ``key`` in the innermost open
    recorder."""
    if _active:
        slot = _active[-1].counts.setdefault(name, {})
        slot[key] = slot.get(key, 0) + n


def once(name: str, seconds: float, **attrs) -> None:
    """Keep a one-time event of ``seconds``, recorder or not."""
    _once.append((name, float(seconds), attrs))


def once_events() -> List[Tuple[str, float, dict]]:
    """The one-time events of this process so far, oldest first."""
    return list(_once)


def self_ns(spans) -> Dict[str, int]:
    """{name: self time in ns} over ``spans`` ((name, start, end, depth)
    of one recorder): each span's duration less the durations of the spans
    one level deeper inside it."""
    out: Dict[str, int] = defaultdict(int)
    open_: List[list] = []  # [name, end, own ns] of the enclosing spans, outermost first
    for name, start, end, _ in sorted(spans, key=lambda s: (s[1], s[3])):
        while open_ and start >= open_[-1][1]:
            done = open_.pop()
            out[done[0]] += done[2]
        if open_:
            open_[-1][2] -= end - start
        open_.append([name, end, end - start])
    for name, _, own in open_:
        out[name] += own
    return dict(out)
