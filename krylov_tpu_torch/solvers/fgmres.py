"""FGMRES — flexible GMRES (Saad 1993); counterpart of
``krylov_tpu.solvers.fgmres``.

GMRES whose right preconditioner may change every iteration, so the
preconditioner can itself be an iterative method (a few CG or Chebyshev
steps, a multigrid cycle).  The flexible basis ``Z`` stores each
preconditioned direction ``z_j = M_j v_j`` explicitly; the solution is
assembled as ``x = x0 + Z y`` from the least-squares coefficients of the
Arnoldi Hessenberg system (Givens-QR, the primitives of :func:`gmres`).

``M`` may be an operator (fixed), a callable ``v -> z``, or a callable
``(j, v) -> z`` receiving the iteration index.  Host-stepped, as in the
reference (the inner preconditioner is arbitrary Python): the Hessenberg
matrix and the rotations stay on the device, and each step reads one pair
of norms back.  Supports ``restart=m`` cycles.
"""

from typing import Callable, Optional

import numpy as np
import torch

from .._info import Info
from .._inner import ensure_real
from ..givens import apply_givens, givens
from ._common import nonzero, preconditioner, setup


def _apply_M(M, j, v):
    if M is None:
        return v
    if callable(M) and not hasattr(M, "__matmul__"):
        try:
            return M(j, v)
        except TypeError:
            return M(v)
    return M @ v


def _combine(y, Z, like):
    """``sum_i y[i] * Z[i]`` in the basis order, from device scalars."""
    out = torch.zeros_like(like)
    for c, z in zip(y, Z):
        out = out + c * z
    return out


def _back_substitute(H, g, j):
    if j == 0:
        return g[:0]
    return torch.linalg.solve_triangular(H[:j, :j], g[:j, None], upper=True)[:, 0]


def fgmres(
    A,
    b,
    M=None,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    restart: Optional[int] = None,
    callback: Optional[Callable] = None,
):
    """Flexible GMRES for general square ``A`` (single RHS)."""
    A, b, x, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    if b.ndim != 1:
        raise ValueError("fgmres supports a single right-hand side")
    if M is not None and hasattr(M, "__matmul__"):
        M = preconditioner(M, b.device)  # a fixed operator or matrix

    def norm(v):
        return torch.sqrt(ensure_real(inner(v, v), "<v, v>"))

    r = b - A @ x
    resnorms = [float(norm(r))]
    criterion = max(tol * resnorms[0], atol)
    if callback is not None:
        callback(x, r)

    a_dtype = getattr(A, "dtype", None)
    dtype = torch.promote_types(
        r.dtype, a_dtype if isinstance(a_dtype, torch.dtype) else torch.float64)
    m = maxiter if restart is None else min(restart, maxiter)
    total = 0
    success = False
    beta_h = resnorms[0]

    while total < maxiter and not success:
        if beta_h <= criterion:
            success = True
            break
        beta = norm(r)
        V = [r / nonzero(beta)]
        Z = []
        cycle = min(m, maxiter - total)
        H = torch.zeros((cycle + 1, cycle), dtype=dtype, device=b.device)
        g = torch.zeros(cycle + 1, dtype=dtype, device=b.device)
        g[0] = beta
        rots = []
        j = 0
        while j < cycle:
            z = _apply_M(M, total + j, V[j])
            w = A @ z
            # modified Gram-Schmidt
            for i in range(j + 1):
                hij = inner(V[i], w)
                H[i, j] = hij
                w = w - hij * V[i]
            hnext = norm(w)
            H[j + 1, j] = hnext
            Z.append(z)
            # apply stored rotations, generate the new one
            for i, G in enumerate(rots):
                H[i : i + 2, j] = apply_givens(G, H[i : i + 2, j])
            G, _ = givens(H[j : j + 2, j])
            rots.append(G)
            H[j : j + 2, j] = apply_givens(G, H[j : j + 2, j])
            g[j : j + 2] = apply_givens(G, g[j : j + 2])

            # the step's one host read: the new basis norm and the residual
            hnext_h, res_h = torch.stack([hnext.to(g.real.dtype), g[j + 1].abs()]).tolist()
            breakdown = hnext_h <= 1e-14 * max(1.0, beta_h)
            if not breakdown:
                V.append(w / hnext)

            total += 1
            j += 1
            resnorms.append(res_h)
            if callback is not None:
                # the callback fires every iteration with the current
                # iterate, assembled on demand
                x_cb = x + _combine(_back_substitute(H, g, j), Z, x.to(dtype))
                callback(x_cb, b - A @ x_cb)
            if res_h <= criterion or breakdown or total >= maxiter:
                break

        # assemble the cycle's iterate: j x j triangular solve (H is upper
        # triangular after the rotation sweep)
        x = x + _combine(_back_substitute(H, g, j), Z, x.to(dtype))
        r = b - A @ x
        # explicit-residual re-check (the library's convergence contract)
        beta_h = float(norm(r))
        resnorms[-1] = beta_h
        if beta_h <= criterion:
            success = True
            break

    info = Info(success, x, total, np.asarray(resnorms, dtype=float))
    return (x if success else None), info
