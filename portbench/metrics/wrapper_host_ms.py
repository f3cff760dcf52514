"""wrapper_host_ms (ms): the self time of the program's pyramid drivers
and kernel wrappers a frame: its ``fused.*``, ``streamed.*``, ``kernel.B*``
and ``separable.*`` spans (checks, allocations, the oracle's torch ops),
over the program's profiled sub-window (``portbench.program_trace``)."""
from portbench.program_trace import per_frame_ms, program_trace

PREFIXES = ("fused.", "streamed.", "kernel.B", "separable.")


def read(run):
    return per_frame_ms(program_trace(run), lambda name: name.startswith(PREFIXES))
