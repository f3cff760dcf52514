"""frame_ms_p95 (ms): the 95th percentile (nearest rank), over every frame of
the window, of the host clock from the call's start to the return of the
wait on that frame's completion event."""
import math


def read(run):
    lat = sorted(run.window.latencies)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
