"""CGR — conjugate residual method (Saad, Iterative Methods 2nd ed., p. 194);
counterpart of ``krylov_tpu.solvers.cgr``.

``M`` is placed as the reference places it: the residual is preconditioned
once up front, and ``M @ Ap`` inside the loop.  ``maxiter`` defaults to N.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import nonzero, preconditioner, setup


class CgrState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    Ap: torch.Tensor
    rAr: torch.Tensor
    resnorm: torch.Tensor


def cgr(
    A,
    b,
    M=None,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, x), "<x, x>"))

    r0 = M @ (b if x0_default else b - A @ x0)
    Ar = A @ r0
    rAr = inner(r0, Ar)

    if callback is not None:
        callback(x0, r0)

    state0 = CgrState(
        x=x0.to(r0.dtype), r=r0, p=r0, Ap=Ar, rAr=rAr, resnorm=_norm(r0),
    )

    def step(s: CgrState, criterion) -> CgrState:
        MAp = M @ s.Ap
        alpha = s.rAr / nonzero(inner(s.Ap, MAp))

        x = s.x + alpha * s.p
        r = s.r - alpha * MAp

        Ar = A @ r
        rAr_new = inner(r, Ar)
        beta = rAr_new / nonzero(s.rAr)

        p = r + beta * s.p
        Ap = Ar + beta * s.Ap
        return CgrState(x=x, r=r, p=p, Ap=Ap, rAr=rAr_new, resnorm=_norm(r))

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s: (s.x, s.r),
        capturable=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
