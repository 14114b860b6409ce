"""Chebyshev iteration: matvec-only, needs eigenvalue estimates
(counterpart of ``krylov_tpu.solvers.chebyshev``).

``eigenvalue_estimates=(lmin, lmax)``, optional ``M``, arbitrary inner.
The k == 0 / k == 1 coefficient special cases test the step number the
driver gives the step (:mod:`.._steps`: a host branch on the host, a
``torch.where`` on the device counter of the graph route); ``p`` starts at
zero, so ``p = z + beta * 0`` is exact at k == 0.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import inner_tail, nonzero, preconditioner, setup


class ChebyshevState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    alpha: torch.Tensor
    resnorm: torch.Tensor


def chebyshev(
    A,
    b,
    eigenvalue_estimates: Tuple[float, float],
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

    if len(eigenvalue_estimates) != 2 or not (
            eigenvalue_estimates[0] <= eigenvalue_estimates[1]):
        raise ValueError("eigenvalue_estimates must be (lmin, lmax), lmin <= lmax")
    lmin, lmax = eigenvalue_estimates
    d = (lmax + lmin) / 2
    c = (lmax - lmin) / 2

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, M @ x), "<x, M x>"))

    r0 = b if x0_default else b - A @ x0

    if callback is not None:
        callback(x0, r0)

    state0 = ChebyshevState(
        x=x0.to(r0.dtype),
        r=r0,
        p=torch.zeros_like(M @ r0),
        alpha=torch.zeros(inner_tail(inner, b), dtype=r0.real.dtype, device=b.device),
        resnorm=_norm(r0),
    )

    def step(s: ChebyshevState, criterion, ctl) -> ChebyshevState:
        z = M @ s.r
        k = ctl.k

        def later():
            q = (c * s.alpha) ** 2
            return ctl.pick(k > 1, lambda: 0.25 * q, lambda: 0.5 * q)

        beta = ctl.pick(k == 0, lambda: torch.zeros_like(s.alpha), later)
        alpha = 1.0 / (d - beta / nonzero(s.alpha))
        p = z + beta * s.p  # exact for k == 0 since p0 == 0 and beta == 0
        x = s.x + alpha * p
        r = s.r - alpha * (A @ p)
        return ChebyshevState(
            x=x, r=r, p=p, alpha=alpha.to(s.alpha.dtype), resnorm=_norm(r),
        )

    method = Method(
        step=step,
        xk=lambda s, k: s.x,
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s, k: (s.x, s.r),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
