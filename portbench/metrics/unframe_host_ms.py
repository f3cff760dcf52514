"""unframe_host_ms (ms): the self time of the program's ``api.unframe``
spans (the stacks of a batch's per-frame results, host side) a frame, over
the program's profiled sub-window (``portbench.program_trace``)."""
from portbench.program_trace import per_frame_ms, program_trace


def read(run):
    return per_frame_ms(program_trace(run), lambda name: name == "api.unframe")
