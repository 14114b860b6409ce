"""CGS — conjugate gradients squared (Sonneveld); counterpart of
``krylov_tpu.solvers.cgs``.

The squared transpose-free recurrence with an SPD preconditioner ``M`` and
an arbitrary inner product.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import initial_residual, inner_tail, nonzero, preconditioner, setup


class CgsState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    rho: torch.Tensor
    resnorm: torch.Tensor
    # in the state, so that a graph kept across solves (make_sharded_solver)
    # reads the solve's own shadow vector
    shadow: torch.Tensor


def cgs(
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
        return torch.sqrt(ensure_real(inner(x, M @ x), "<x, M x>"))

    r0 = initial_residual(A, b, x0, x0_default)
    rp = r0  # common but arbitrary choice of the shadow vector

    if callback is not None:
        callback(x0, r0)

    vdtype = r0.dtype
    state0 = CgsState(
        x=x0.to(vdtype),
        r=r0,
        p=torch.zeros_like(r0),
        q=torch.zeros_like(r0),
        rho=torch.ones(inner_tail(inner, b), dtype=vdtype, device=b.device),
        resnorm=_norm(r0),
        shadow=rp,
    )

    def step(s: CgsState, criterion) -> CgsState:
        rho = inner(s.shadow, s.r)
        beta = rho / nonzero(s.rho)
        u = s.r + beta * s.q
        p = u + beta * (s.q + beta * s.p)

        v = A @ (M @ p)
        alpha = rho / nonzero(inner(s.shadow, v))

        q = u - alpha * v
        u_ = M @ (u + q)

        x = s.x + alpha * u_
        r = s.r - alpha * (A @ u_)
        return CgsState(x=x, r=r, p=p, q=q, rho=rho.to(vdtype), resnorm=_norm(r),
                        shadow=s.shadow)

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
