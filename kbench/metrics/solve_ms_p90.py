"""The 90th percentile of the window's solve calls, each timed from the
call to its synchronised return (host clock)."""

from kbench.harness.stats import percentile


def read(run):
    return percentile([c.ms for c in run.calls], 90)
