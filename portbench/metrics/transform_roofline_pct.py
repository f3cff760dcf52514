"""transform_roofline_pct (%): the least time the card could take for a
frame's transform (portbench.work's bytes and operations against the
card's published peaks, portbench.peaks) over the device time of a frame,
which is the sum of every device record of the traced sub-window over its
frames, whatever ran the transform (kernels, copies, stacks)."""
from portbench.peaks import least_seconds
from portbench.work import bytes_per_frame, ops_per_frame


def read(run):
    if run.trace is None or not run.trace.records or not run.trace.window.frames:
        return None
    least = least_seconds(bytes_per_frame(run.cfg), ops_per_frame(run.cfg),
                          run.cfg["dtype"].startswith("int"), run.device_name)
    device_s = sum(dur for _, _, dur in run.trace.records) / 1e9 / run.trace.window.frames
    if least is None or device_s <= 0:
        return None
    return 100.0 * least / device_s
