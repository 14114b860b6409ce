"""Mixed-precision iterative refinement (counterpart of
``krylov_tpu.solvers.refine``).

Run the inner Krylov solve in a cheap dtype (a bf16 matrix stream: half
the memory traffic of the values) and recover working-precision accuracy
with an outer defect-correction loop:

    r_k = b - A x_k               (working precision)
    d_k = solve_low(A_low, r_k)   (low precision, loose tolerance)
    x_{k+1} = x_k + d_k

Classic Wilkinson refinement: each outer step multiplies the error by the
inner solve's residual-reduction factor, while all rounding happens against
the working-precision residual, so the iterate converges to the working
precision's accuracy even though the inner solver never sees it.  The
outer loop runs on the host and reads one norm per outer step.
"""

from typing import Callable

import numpy as np
import torch

from .. import _device
from .._info import Info
from .._operators import as_operator
from .cg import cg


def refine(
    A,
    b,
    A_low=None,
    solver: Callable = cg,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 50,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: int = 50,
    x0=None,
    inner=None,
    **solver_kwargs,
):
    """Defect-correction refinement of ``A x = b``.

    * ``A``: working-precision operator (residuals are computed with it).
    * ``A_low``: low-precision operator for the inner solves (default:
      ``A`` itself, plain restarted refinement).
    * ``solver`` / ``inner_tol`` / ``inner_maxiter``: the inner solve; its
      iterates are computed in ``A_low``'s dtype.
    * ``tol``/``atol``/``maxiter``: outer convergence on the
      working-precision residual (absolute resnorms).

    Returns ``(sol_or_None, Info)`` with the outer residual history.
    """
    b = _device.as_tensor(b, _device.device_of(A))
    A = as_operator(A, device=b.device)
    A_low = A if A_low is None else as_operator(A_low, device=b.device)
    low_dtype = getattr(A_low, "dtype", b.dtype)
    if not isinstance(low_dtype, torch.dtype):
        low_dtype = b.dtype

    if inner is None:
        def inner(u, v):
            return torch.sum(u.conj() * v)

    def norm(v):
        return float(torch.sqrt(torch.as_tensor(inner(v, v)).real))

    x = torch.zeros_like(b) if x0 is None else _device.as_tensor(x0, b.device)
    r = b - (A @ x)
    resnorms = [norm(r)]
    criterion = max(tol * resnorms[0], atol)
    success = False
    k = 0
    while True:
        if resnorms[-1] <= criterion:
            success = True
            break
        if k == maxiter:
            break
        safe = resnorms[-1] if resnorms[-1] != 0 else 1.0
        r_low = (r / safe).to(low_dtype)
        inner_kw = dict(solver_kwargs)
        inner_kw.setdefault("backend", "while_loop")
        _, info = solver(
            A_low, r_low, tol=inner_tol, maxiter=inner_maxiter, **inner_kw
        )
        x = x + info.xk.to(b.dtype) * safe
        r = b - (A @ x)
        resnorms.append(norm(r))
        k += 1

    info = Info(success, x, k, np.asarray(resnorms), None, None)
    return (x if success else None), info
