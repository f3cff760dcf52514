"""setup_s (s): from the start of the process's first statement to the
window's start: imports, the card, the build of the kernels where it is
not yet in the checkout, the pool of frames, the warm-up."""


def read(run):
    return run.setup_s
