"""The share of the window's steps that ran in replayed CUDA graphs:
the port's ``_driver.COUNTS`` graph_steps over host_steps + graph_steps."""


def read(run):
    graph = sum(c.counts["driver.graph_steps"] for c in run.calls)
    host = sum(c.counts["driver.host_steps"] for c in run.calls)
    return graph / (graph + host) if graph + host else None
