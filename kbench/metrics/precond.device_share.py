"""The share of the traced window's device time spent in kernels launched
inside the harness's span around each preconditioner application
(``kbench.precond``; the profiler ties a kernel to the host operation
that launched it)."""


def read(run):
    if run.trace is None or "kbench.precond" not in run.trace.spans:
        return None
    total = sum(v[0] for v in run.trace.kernels.values())
    return run.trace.spans["kbench.precond"] / total if total > 0 else None
