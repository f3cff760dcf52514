"""host_submit_ms (ms): the harness's own span around each call into the
API (host clock, from the call to its return, the work only enqueued),
the mean over every frame of the window."""


def read(run):
    if not run.window.submits:
        return None
    return 1e3 * sum(run.window.submits) / len(run.window.submits)
