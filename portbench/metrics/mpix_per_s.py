"""mpix_per_s (Mpix/s): component samples transformed over the whole window
time, all frames counted (host clock, from the first call's start to the
last frame's completion)."""
from portbench.work import samples_per_frame


def read(run):
    if run.window.frames == 0:
        return None
    return run.window.frames * samples_per_frame(run.cfg) / run.window.seconds / 1e6
