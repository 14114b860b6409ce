"""BiCG — biconjugate gradients, the two-sided recurrence (counterpart of
``krylov_tpu.solvers.bicg``).

SPD preconditioner ``M`` applied through both ``M @`` and ``M.rmatvec``, a
dual residual pair, the adjoint matvec on ``A``.  The callback's second
argument is the stacked pair ``[r, r_dual]``.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import initial_residual, nonzero, preconditioner, setup


class BicgState(NamedTuple):
    x: torch.Tensor
    r0: torch.Tensor  # residual
    r1: torch.Tensor  # dual (shadow) residual
    p0: torch.Tensor
    p1: torch.Tensor
    rMr: torch.Tensor
    resnorm: torch.Tensor


def bicg(
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
    A, b, x0, N, inner, maxiter = setup(
        A, b, x0=x0, inner=inner, maxiter=maxiter, needs_rmatvec=True
    )
    M = preconditioner(M, b.device)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, M @ x), "<x, M x>"))

    r0 = initial_residual(A, b, x0, x0_default)
    r1 = r0.conj().resolve_conj()

    if callback is not None:
        callback(x0, torch.stack([r0, r1]))

    p0 = M @ r0
    p1 = M.rmatvec(r1)
    rMr = inner(r1, M @ r0)

    state0 = BicgState(
        x=x0.to(p0.dtype),
        r0=r0.to(p0.dtype),
        r1=r1.to(p0.dtype),
        p0=p0,
        p1=p1,
        rMr=rMr,
        resnorm=_norm(r0),
    )

    def step(s: BicgState, criterion) -> BicgState:
        Ap0 = A @ s.p0
        AHp1 = A.rmatvec(s.p1)
        alpha = s.rMr / nonzero(inner(s.p1, Ap0))

        x = s.x + alpha * s.p0
        r0 = s.r0 - alpha * Ap0
        r1 = s.r1 - alpha.conj() * AHp1

        rMr_new = inner(r1, M @ r0)
        beta = rMr_new / nonzero(s.rMr)

        p0 = M @ r0 + beta * s.p0
        p1 = M.rmatvec(r1) + beta.conj() * s.p1
        return BicgState(
            x=x, r0=r0, r1=r1, p0=p0, p1=p1, rMr=rMr_new, resnorm=_norm(r0)
        )

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s: (s.x, torch.stack([s.r0, s.r1])),
        capturable=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
