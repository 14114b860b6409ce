"""Plain PyTorch preconditioned conjugate gradients.

The recurrence of ``krylov_tpu_torch.cg`` written again from its
definition: ``x0 = 0``, the residual norm ``sqrt(<r, M r>)``, the stop at
``max(tol * norm0, atol)`` for every column, and at each such event the
explicit residual ``b - A x`` checked again, its norm written over the
history's last entry, the steps going on where it fails.  Vectors are
grid-shaped ``(*grid, *tail)``; each trailing column is its own system and
the inner products sum over the grid axes.  Imports nothing of the port.
"""

from typing import NamedTuple

import numpy as np
import torch


class Result(NamedTuple):
    x: torch.Tensor
    numsteps: int
    resnorms: np.ndarray  # (numsteps + 1, *tail), float64
    success: bool


def solve(A, b, M=None, tol=1e-5, atol=1e-15, maxiter=None):
    """CG on ``A x = b`` (``A``, ``M``: objects with ``@`` on grid vectors)."""
    nd = len(A.grid)
    axes = tuple(range(nd))
    maxiter = A.n if maxiter is None else int(maxiter)

    def inner(u, v):
        return torch.sum(u * v, dim=axes)

    def prec(r):
        return r if M is None else M @ r

    def norm(r):
        return torch.sqrt(inner(r, prec(r)))

    x = torch.zeros_like(b)
    r = b.clone()
    z = prec(r)
    rho = inner(r, z)
    res = torch.sqrt(rho)
    crit = torch.clamp(tol * res, min=atol)
    hist = [res]
    p = torch.zeros_like(b)
    rho_old = torch.ones_like(rho)
    k, success = 0, False
    while True:
        if bool(torch.all(hist[-1] <= crit)):
            hist[-1] = norm(b - A @ x)
            if bool(torch.all(hist[-1] <= crit)):
                success = True
                break
        if k == maxiter:
            break
        omega = rho / torch.where(rho_old != 0, rho_old, 1.0)
        p = z + omega * p
        Ap = A @ p
        pAp = inner(p, Ap)
        alpha = rho / torch.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rho_old, rho = rho, inner(r, z)
        hist.append(torch.sqrt(rho))
        k += 1
    resnorms = torch.stack(hist).double().cpu().numpy()
    return Result(x, k, resnorms, success)
