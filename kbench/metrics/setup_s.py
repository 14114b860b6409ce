"""Process start to the first timed call: imports, the kernels' build or
load, the operator and preconditioner, the warm-up solves (host clock)."""


def read(run):
    return run.setup_s
