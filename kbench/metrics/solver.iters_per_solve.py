"""The mean numsteps a solve call of the window took."""


def read(run):
    return sum(c.steps for c in run.calls) / len(run.calls)
