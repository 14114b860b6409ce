"""The correctness check: the port's answers judged by the plain reference.

For each sampled solve of the window the reference recomputes, from the
right-hand side the harness made and handed to the port:

* ``relres``: the true relative residual ``||b - A x|| / ||b||`` of the
  returned ``x``, by the reference stencil in float64 (the largest column);
* ``hist_gap``: the widest gap between the port's residual history and the
  reference solve's, step by step, over the reference's first norm;
* ``steps_gap``: where a tolerance stops the solve, ``|n - n_ref| / n_ref``
  between the port's step count and the reference's;
* ``unconverged``: where a tolerance stops the solve, the sampled solves
  that did not reach it.

Each number is the largest over the samples.  A cell's workload file sets
the limit of each number it compares; ``correct`` needs every one of them
finite and within its limit.
"""

import math

import numpy as np
import torch

from kbench.reference import cg as ref_cg


def grid_view(v, grid):
    """A flat ``(N,)`` or ``(N, k)`` vector as ``(*grid)`` or ``(*grid, k)``."""
    return v.reshape(tuple(grid) + tuple(v.shape[1:]))


def numbers(samples, rhs, A64, reference_solve, wl):
    """``{name: value}`` over ``samples`` (``(call index, info)`` pairs)."""
    out = {"relres": 0.0, "hist_gap": 0.0}
    stops = wl["tol"] > 0 or wl["atol"] > 0
    if stops:
        out.update(steps_gap=0.0, unconverged=0.0)
    axes = tuple(range(len(A64.grid)))
    for i, info in samples:
        b = grid_view(rhs.make(i), A64.grid)
        x = grid_view(info.xk, A64.grid)
        b64 = b.double()
        res = torch.linalg.vector_norm(b64 - A64 @ x.double(), dim=axes)
        rel = res / torch.linalg.vector_norm(b64, dim=axes)
        out["relres"] = max(out["relres"], _worst(rel))
        ref = reference_solve(b)
        hist = np.asarray(info.resnorms, dtype=np.float64)
        m = min(len(hist), len(ref.resnorms))
        gap = np.abs(hist[:m] - ref.resnorms[:m]).max(axis=0) / ref.resnorms[0]
        out["hist_gap"] = max(out["hist_gap"], _worst(torch.as_tensor(gap)))
        if stops:
            out["steps_gap"] = max(out["steps_gap"],
                                   abs(info.numsteps - ref.numsteps) / max(ref.numsteps, 1))
            out["unconverged"] += 0.0 if info.success else 1.0
        del b, x, b64, res, ref
    return out


def _worst(t):
    """The largest entry, NaN where any entry is not finite."""
    t = torch.as_tensor(t, dtype=torch.float64)
    return float(t.max()) if bool(torch.isfinite(t).all()) else math.nan


def verdict(values, limits):
    """``(correct, {name: {"value", "limit"}})`` for the numbers with a limit."""
    checks = {k: {"value": values.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def reference_solver(A_ref, M_ref, wl):
    """``solve(b)`` by the reference CG with the workload's stop."""
    def solve(b):
        return ref_cg.solve(A_ref, b.to(A_ref.dtype), M=M_ref, tol=wl["tol"],
                            atol=wl["atol"], maxiter=wl["maxiter"])
    return solve
