"""TFQMR — transpose-free quasi-minimal residual (Freund, SISC 1993);
counterpart of ``krylov_tpu.solvers.tfqmr``.

The quasi-minimization of QMR over the CGS iterates, built from ``A``
alone: no ``rmatvec``, so it accepts matvec-only operators while smoothing
CGS's erratic residuals.

One step of the solve loop is one TFQMR **half-step** (Saad, *Iterative
Methods for Sparse Linear Systems* 2nd ed., alg. 7.4), so the residual
history has the resolution of scipy's ``tfqmr`` and convergence can fire
mid-pair.  The
parity of the half-step is the step number the driver gives the step, not
data (:mod:`.._steps`): on the host the even/odd updates are host branches,
which cost no device read; on the graph route both are computed and
selected with ``torch.where`` on the device counter, as the reference does
inside one traced program (one more reduction a half-step there).  Cost
per half-step on the host: 1 matvec, 1 ``M`` apply, 2 reductions.

Preconditioning is right-sided (``A @ M``), so ``w`` lives in the true
residual space and the reported quasi-residual bound ``tau * sqrt(j + 1)``
bounds the genuine residual norm; the solution update carries ``M @ d``
beside ``d`` to avoid a second ``M`` apply.  On convergence the solve loop
overwrites the final history entry with the explicit residual norm.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._steps import at
from ._common import initial_residual, inner_tail, nonzero, preconditioner, setup


class TfqmrState(NamedTuple):
    x: torch.Tensor
    w: torch.Tensor  # CGS-style residual chain (true-residual space)
    u: torch.Tensor  # current direction u_j
    v: torch.Tensor  # v vector of the current pair (built at even steps)
    vtail: torch.Tensor  # A u_odd + beta v  (consumed by the next even step)
    d: torch.Tensor  # quasi-minimization direction
    dM: torch.Tensor  # M @ d, carried to keep one M apply per half-step
    alpha: torch.Tensor
    beta: torch.Tensor
    rho: torch.Tensor
    theta: torch.Tensor
    eta: torch.Tensor
    tau: torch.Tensor
    resnorm: torch.Tensor


def tfqmr(
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
    """Solve ``A x = b`` with TFQMR (right-preconditioned by ``M``).

    ``maxiter`` counts half-steps (= matvecs), as scipy's ``tfqmr`` does;
    ``maxiter=None`` defaults to ``2 N`` since one Krylov dimension costs
    two half-steps.  An explicit ``maxiter`` is honoured verbatim.

    ``callback(x, w)`` receives the CGS residual-chain vector ``w`` as its
    second argument, not ``b - A x`` of the quasi-minimized iterate (that
    would cost an extra matvec per half-step); the pre-loop call and the
    loop's final explicit re-check do use the true residual.
    """
    was_none = maxiter is None
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    if was_none:
        # a full Krylov sweep is 2N half-steps for this method
        maxiter = 2 * N
    M = preconditioner(M, b.device)

    def _norm(z):
        return torch.sqrt(ensure_real(inner(z, z), "<w, w>"))

    r0 = initial_residual(A, b, x0, x0_default)
    rstar = r0  # shadow vector: the customary r*_0 = r_0

    if callback is not None:
        callback(x0, r0)

    sdtype = r0.dtype
    tail = inner_tail(inner, b)
    tau0 = _norm(r0)
    rdtype = tau0.dtype

    def zeros(dtype):
        return torch.zeros(tail, dtype=dtype, device=b.device)

    # sqrt(j + 1) of the quasi-residual bound, by the half-step's number
    roots = torch.sqrt(torch.arange(1, maxiter + 2, dtype=torch.float64,
                                    device=b.device)).to(rdtype)

    state0 = TfqmrState(
        x=x0.to(sdtype),
        w=r0,
        u=r0,
        v=torch.zeros_like(r0),
        vtail=torch.zeros_like(r0),
        d=torch.zeros_like(r0),
        dM=torch.zeros_like(r0),
        alpha=zeros(sdtype),
        beta=zeros(sdtype),
        rho=inner(rstar, r0).to(sdtype),
        theta=zeros(rdtype),
        eta=zeros(sdtype),
        tau=tau0,
        resnorm=tau0,
    )

    def step(s: TfqmrState, criterion, ctl) -> TfqmrState:
        j = ctl.k
        even = j % 2 == 0

        Mu = M @ s.u
        Au = A @ Mu

        # the single recurrence inner product of the half-step: <r*, v> at
        # even steps (for alpha), <r*, w_new> at odd ones (for rho)
        def even_half():
            # this pair's v = A u_even + beta (A u_odd + beta v)
            v = Au + s.beta * s.vtail
            ip = inner(rstar, v)
            alpha = (s.rho / nonzero(ip)).to(sdtype)
            return v, alpha, s.w - alpha * Au, ip.to(sdtype)

        def odd_half():
            w = s.w - s.alpha * Au
            return s.v, s.alpha, w, inner(rstar, w).to(sdtype)

        v, alpha, w, ip = ctl.pick(even, even_half, odd_half)

        scale = s.theta * s.theta * s.eta / nonzero(alpha)
        d = s.u + scale * s.d
        dM = Mu + scale * s.dM

        theta = _norm(w) / nonzero(s.tau)
        c2 = 1.0 / (1.0 + theta * theta)
        tau = s.tau * theta * torch.sqrt(c2)
        eta = c2.to(sdtype) * alpha
        x = s.x + eta * dM

        def odd_tail():
            beta = (ip / nonzero(s.rho)).to(sdtype)
            return ip, beta, w + beta * s.u, Au + beta * v

        rho, beta, u, vtail = ctl.pick(
            even, lambda: (s.rho, s.beta, s.u - alpha * v, s.vtail), odd_tail)

        tau = tau.to(rdtype)
        # quasi-residual bound ||r_j|| <= tau_j sqrt(j + 1), after this half-step
        resnorm = tau * at(roots, j + 1)
        return TfqmrState(
            x=x, w=w, u=u, v=v, vtail=vtail, d=d, dM=dM,
            alpha=alpha, beta=beta,
            rho=rho, theta=theta.to(rdtype),
            eta=eta.to(sdtype), tau=tau,
            resnorm=resnorm,
        )

    method = Method(
        step=step,
        xk=lambda s, k: s.x,
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s, k: (s.x, s.w),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
