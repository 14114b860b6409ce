"""BiCGSTAB (van der Vorst) with left and right preconditioning
(counterpart of ``krylov_tpu.solvers.bicgstab``).

It keeps the reference's mid-iteration exit: after the half step it
evaluates the explicit residual norm of the *previous* iterate (a quirk
kept from the reference: it tests ``x``, not the half-step iterate ``h``)
and, when that already meets the criterion, ends the solve without
completing the step, carried as ``early_success`` on the state, which both
drivers honour (:mod:`krylov_tpu_torch._driver`).  Every guard is a
``torch.where`` on the device, so a step reads nothing back.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import initial_residual, inner_tail, nonzero, preconditioner, setup


class BicgstabState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    resnorm: torch.Tensor
    early_success: torch.Tensor


def bicgstab(
    A,
    b,
    Ml=None,
    Mr=None,
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
    Ml = preconditioner(Ml, b.device)
    Mr = preconditioner(Mr, b.device)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, Ml @ x), "<x, Ml x>"))

    r0 = initial_residual(A, b, x0, x0_default)
    r0_shadow = r0  # common but arbitrary choice

    if callback is not None:
        callback(x0, r0)

    resnorm0 = _norm(r0)
    vdtype = r0.dtype
    tail = inner_tail(inner, b)

    def scal(val):
        return torch.full(tail, val, dtype=vdtype, device=b.device)

    state0 = BicgstabState(
        x=x0.to(vdtype),
        r=r0,
        p=torch.zeros_like(r0),
        v=torch.zeros_like(r0),
        rho=scal(1.0),
        alpha=scal(1.0),
        omega=scal(1.0),
        resnorm=resnorm0,
        early_success=torch.zeros((), dtype=torch.bool, device=b.device),
    )

    def step(s: BicgstabState, criterion) -> BicgstabState:
        rho = inner(r0_shadow, s.r)
        beta = rho * s.alpha / nonzero(s.rho * s.omega)

        p = s.r + beta * (s.p - s.omega * s.v)
        y = Mr @ (Ml @ p)
        v = A @ y

        alpha = rho / nonzero(inner(r0_shadow, v))
        s_vec = s.r - alpha * v
        h = s.x + alpha * y

        # mid-iteration convergence probe on the previous iterate (the
        # reference's quirk: x, not h)
        resnorm_h = _norm(Ml @ (b - A @ s.x))
        early = torch.all(resnorm_h <= criterion)

        Ml_s = Ml @ s_vec
        z = Mr @ Ml_s
        t = A @ z
        Ml_t = Ml @ t
        omega = inner(Ml_t, Ml_s) / nonzero(inner(Ml_t, Ml_t))

        x_new = h + omega * z
        r_new = s_vec - omega * t

        return BicgstabState(
            x=torch.where(early, s.x, x_new),
            r=torch.where(early, s.r, r_new),
            p=p,
            v=v,
            rho=rho.to(vdtype),
            alpha=alpha.to(vdtype),
            omega=torch.where(early, s.omega, omega).to(vdtype),
            resnorm=torch.where(early, resnorm_h, _norm(r_new)),
            early_success=early,
        )

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
