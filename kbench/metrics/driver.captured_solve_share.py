"""The share of the window's solve calls that captured or replayed a CUDA
graph (the port's ``_driver.COUNTS`` captures or replays rose)."""


def read(run):
    hit = sum(1 for c in run.calls
              if c.counts["driver.captures"] > 0 or c.counts["driver.replays"] > 0)
    return hit / len(run.calls)
