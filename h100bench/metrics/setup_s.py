"""Seconds from the process's start to the end of the warm-up request: the
kernel build (on a checkout's first run), the weights made on the card, the
pipeline built, one request of the cell's own shapes."""


def read(run, name):
    return run.setup_s
