"""Entry ``solve``: one call of the port's solver named by the workload,
``kt.<solver>(A, b, M=M, tol=, atol=, maxiter=, backend="while_loop")``,
on one device, ``M`` built once from the workload's ``precond``."""

from kbench.harness import spec


def port(kt, A, wl, wrap=None):
    """``call(b) -> info``: the solve of one right-hand side block ``b``
    (flat ``(N,)`` or ``(N, k)``); ``info.xk`` is the iterate returned.
    ``wrap``, where given, wraps the preconditioner."""
    pre = wl.get("precond")
    M = None if pre is None else spec.part(pre["kind"]).port(kt, A, pre["args"])
    if wrap is not None and M is not None:
        M = wrap(M)
    solver = getattr(kt, wl["solver"])
    kw = dict(tol=wl["tol"], atol=wl["atol"], maxiter=wl["maxiter"], backend="while_loop")

    def call(b):
        return solver(A, b, M=M, **kw)[1]

    return call
