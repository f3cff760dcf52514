"""launch_host_ms (ms): the self time of the program's ``kernel.launch``
spans (the entry point's lookup, the lifting parameters, the stream, the
ctypes call of each CUDA launch) a frame, over the program's profiled
sub-window (``portbench.program_trace``)."""
from portbench.program_trace import per_frame_ms, program_trace


def read(run):
    return per_frame_ms(program_trace(run), lambda name: name == "kernel.launch")
