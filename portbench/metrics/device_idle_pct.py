"""device_idle_pct (%): 1 - (union of the device records' intervals) / the
traced sub-window's host time, in percent."""
from portbench.tracing import union_ns


def read(run):
    if run.trace is None or not run.trace.records or run.trace.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - union_ns(run.trace.records) / 1e9 / run.trace.window.seconds)
