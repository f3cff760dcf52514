"""kernel_load_s (s): the seconds of the program's one-time ``cuda.build``
(the kernels' build, or finding them built) and ``cuda.load`` (loading
their libraries) events in the run's process, read in a traced run on the
card; 0.0 where the process loaded no kernel."""
from portbench.program_trace import load_seconds


def read(run):
    if run.trace is None:
        return None
    return load_seconds()
