"""Seconds from the run's start to the window's: imports, the kernels'
load (their build in a checkout's first run), the inputs, the builder's
staging and the warm-up epoch."""


def read(run):
    return run.setup_s
