"""launches_per_frame (launches): device records (kernels, copies, fills)
that the profiler (CUPTI) took over the traced sub-window, over its
frames."""


def read(run):
    if run.trace is None or not run.trace.records or not run.trace.window.frames:
        return None
    return len(run.trace.records) / run.trace.window.frames
