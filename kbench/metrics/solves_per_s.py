"""Right-hand sides solved over the whole window, every column of a
blocked call counted (host clock)."""


def read(run):
    return sum(c.rhs for c in run.calls) / run.window_s
