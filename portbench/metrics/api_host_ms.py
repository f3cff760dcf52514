"""api_host_ms (ms): the self time of the program's ``api.*`` spans
(``libdwt_torch.api``: the 2-D entries, ``api.dispatch``, ``api.unframe``)
a frame, over a profiled sub-window with the program's recorder open
(``portbench.program_trace``)."""
from portbench.program_trace import per_frame_ms, program_trace


def read(run):
    return per_frame_ms(program_trace(run), lambda name: name.startswith("api."))
