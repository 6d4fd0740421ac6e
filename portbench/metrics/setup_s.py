"""Seconds from the start of the process until the window opens: imports,
CUDA start, the kernel library (built on a checkout's first run, loaded
after) and the warm-up batch."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
