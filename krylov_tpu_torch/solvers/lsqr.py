"""LSQR — least squares via Golub-Kahan bidiagonalization (Paige &
Saunders, ACM TOMS 1982); counterpart of ``krylov_tpu.solvers.lsqr``.

CGNE/CGNR square the condition number; LSQR works on ``A`` directly through
the bidiagonalization and is the numerically sound tool for rectangular and
ill-conditioned systems.  Supports rectangular ``A`` (the only solver
family here that does), Tikhonov damping
``min ||b - A x||^2 + damp^2 ||x||^2``, blocked multi-RHS, complex
operators, and both backends.

Stopping combines the library's uniform residual criterion
``||r|| <= max(tol * ||r0||, atol)`` (with the explicit-residual double
check) with the least-squares criterion
``||A^H r|| <= max(tol * ||A|| * ||r||, atol)``, the one an inconsistent
system can satisfy; it exits through the solve loop's ``early_success``
mechanism, folded into the step's one stop-flag read.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .. import _device
from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import as_inner, ensure_real
from .._operators import as_operator
from ._common import nonzero


class LsqrState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor  # left Lanczos vector  (m-space)
    v: torch.Tensor  # right Lanczos vector (n-space)
    w: torch.Tensor  # search direction     (n-space)
    alpha: torch.Tensor
    phibar: torch.Tensor
    rhobar: torch.Tensor
    anorm2: torch.Tensor  # running ||B_k||_F^2 estimate of ||A||^2
    resnorm: torch.Tensor
    early_success: torch.Tensor


def lsqr(
    A,
    b,
    damp: float = 0.0,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Solve ``min ||b - A x||`` (+ optional damping) by LSQR.

    ``A`` may be rectangular ``(m, n)``; it must provide ``rmatvec`` (the
    adjoint matvec), as every two-sided solver here does.  Returns the
    library's uniform ``(sol_or_None, Info)``; ``info.resnorms`` is the
    ``||b - A x_k||`` history.  When the solve stops on the least-squares
    criterion (inconsistent systems), the final history entry is the
    converged iterate's residual estimate.
    """
    b = _device.as_tensor(b, _device.device_of(A))
    A = as_operator(A, device=b.device)
    if hasattr(A, "ensure_adjoint"):
        A.ensure_adjoint()
    m, n = A.shape
    if b.shape[0] != m:
        raise ValueError(f"A {A.shape} does not match b {tuple(b.shape)}")
    rhs_shape = tuple(b.shape[1:])
    inner_u = as_inner(inner, b.shape)
    inner_v = as_inner(inner, (n,) + rhs_shape)
    if maxiter is None:
        maxiter = 2 * min(m, n)
    damp = float(damp)

    def _norm_u(z):
        return torch.sqrt(torch.abs(ensure_real(inner_u(z, z), "<u, u>")))

    def _norm_v(z):
        return torch.sqrt(torch.abs(ensure_real(inner_v(z, z), "<v, v>")))

    if x0 is None:
        x_init = torch.zeros((n,) + rhs_shape, dtype=b.dtype, device=b.device)
        r0 = b
    else:
        x_init = _device.as_tensor(x0, b.device)
        r0 = b - A @ x_init

    beta0 = _norm_u(r0)
    u = r0 / nonzero(beta0)
    Ahu = A.rmatvec(u)
    alpha0 = _norm_v(Ahu)
    v = Ahu / nonzero(alpha0)

    x_init = x_init.to(v.dtype)
    if callback is not None:
        callback(x_init, r0)

    state0 = LsqrState(
        x=x_init,
        u=u,
        v=v,
        w=v,
        alpha=alpha0,
        phibar=beta0,
        rhobar=alpha0,
        # starts at 0 (Paige-Saunders, scipy): the first step adds
        # alpha0^2 + beta1^2 itself; seeding alpha0^2 here would count it
        # twice and loosen the least-squares stopping test
        anorm2=torch.zeros_like(alpha0),
        resnorm=beta0,
        early_success=torch.zeros((), dtype=torch.bool, device=b.device),
    )

    def step(s: LsqrState, criterion) -> LsqrState:
        # Golub-Kahan bidiagonalization: next left/right vectors
        u = A @ s.v - s.alpha * s.u
        beta = _norm_u(u)
        u = u / nonzero(beta)
        v = A.rmatvec(u) - beta * s.v
        alpha = _norm_v(v)
        v = v / nonzero(alpha)

        # eliminate the damping row (no-op when damp == 0)
        rhobar1 = torch.sqrt(s.rhobar * s.rhobar + damp * damp)
        c1 = s.rhobar / nonzero(rhobar1)
        phibar_d = c1 * s.phibar

        # plane rotation zeroing the subdiagonal beta
        rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
        c = rhobar1 / nonzero(rho)
        sn = beta / nonzero(rho)
        theta = sn * alpha
        rhobar = -c * alpha
        phi = c * phibar_d
        phibar = sn * phibar_d

        x = s.x + (phi / nonzero(rho)) * s.w
        w = v - (theta / nonzero(rho)) * s.w

        anorm2 = s.anorm2 + s.alpha * s.alpha + beta * beta + damp * damp
        # the rotations carry signed recurrences (rhobar = -c alpha flips
        # phibar through later products); every norm-valued quantity takes
        # the absolute value
        resnorm = torch.abs(phibar)
        # ||A^H r_k|| = |phibar * alpha * c| (Paige & Saunders eq. 5.2)
        arnorm = torch.abs(phibar * alpha * c)
        ls_ok = arnorm <= torch.clamp(tol * torch.sqrt(anorm2) * resnorm, min=atol)
        return LsqrState(
            x=x, u=u, v=v, w=w, alpha=alpha, phibar=phibar,
            rhobar=rhobar, anorm2=anorm2, resnorm=resnorm,
            early_success=torch.all(ls_ok),
        )

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=lambda xk: _norm_u(b - A @ xk),
        # r_k = phibar_k * u_{k+1} exactly (in exact arithmetic)
        callback_args=lambda s: (s.x, s.phibar * s.u),
        capturable=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
