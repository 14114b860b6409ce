"""The window's seconds over all the Krylov steps it ran (the calls'
numsteps summed), in microseconds."""


def read(run):
    steps = sum(c.steps for c in run.calls)
    return run.window_s / steps * 1e6 if steps else None
