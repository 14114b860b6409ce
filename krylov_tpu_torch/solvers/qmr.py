"""QMR — quasi-minimal residual (Freund & Nachtigal), coupled two-term form
(counterpart of ``krylov_tpu.solvers.qmr``).

Split ``Ml``/``Mr`` preconditioning with adjoint applications on ``A``,
``Ml`` and ``Mr``; quasi-residual scalar recurrence (theta, gamma, eta);
breakdown guards as ``torch.where`` on the device, so a step reads nothing
back.  The k==0 initializations of p/q/d/s collapse into the general
recurrence by zero-initializing those vectors.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import initial_residual, inner_tail, nonzero, preconditioner, setup


class QmrState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    v_: torch.Tensor
    y: torch.Tensor
    w_: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    d: torch.Tensor
    s: torch.Tensor
    rho: torch.Tensor
    xi: torch.Tensor
    gamma: torch.Tensor
    eta: torch.Tensor
    theta: torch.Tensor
    epsilon: torch.Tensor
    resnorm: torch.Tensor


def qmr(
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
    A, b, x0, N, inner, maxiter = setup(
        A, b, x0=x0, inner=inner, maxiter=maxiter, needs_rmatvec=True
    )
    Ml = preconditioner(Ml, b.device)
    Mr = preconditioner(Mr, b.device)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, Ml @ x), "<x, Ml x>"))

    r0 = initial_residual(A, b, x0, x0_default)

    if callback is not None:
        callback(x0, r0)

    v_ = r0
    y = Ml @ v_
    rho0 = _norm(y)
    w_ = r0
    z = Mr.rmatvec(w_)
    xi0 = _norm(z)

    # real scalars (rho, xi, gamma, theta) keep the real dtype, complex ones
    # (eta, epsilon) the vector dtype
    vdtype = torch.promote_types(y.dtype, z.dtype)
    tail = inner_tail(inner, b)
    rdtype = rho0.dtype

    def scal(val, dtype):
        return torch.full(tail, val, dtype=dtype, device=b.device)

    zeros_v = torch.zeros(b.shape, dtype=vdtype, device=b.device)
    state0 = QmrState(
        x=x0.to(vdtype),
        r=r0.to(vdtype),
        v_=v_.to(vdtype),
        y=y.to(vdtype),
        w_=w_.to(vdtype),
        z=z.to(vdtype),
        p=zeros_v,
        q=zeros_v,
        d=zeros_v,
        s=zeros_v,
        rho=rho0,
        xi=xi0,
        gamma=scal(1.0, rdtype),
        eta=scal(-1.0, vdtype),
        theta=scal(1.0, rdtype),
        epsilon=scal(1.0, vdtype),
        resnorm=_norm(r0),
    )

    def step(st: QmrState, criterion) -> QmrState:
        safe_rho = nonzero(st.rho)
        safe_xi = nonzero(st.xi)
        v = st.v_ / safe_rho
        y = st.y / safe_rho
        w = st.w_ / safe_xi
        z = st.z / safe_xi

        delta = inner(z, y)
        y_ = Mr @ y
        z_ = Ml.rmatvec(z)

        delta_eps = delta / nonzero(st.epsilon)
        p = y_ - (st.xi * delta_eps) * st.p
        q = z_ - (st.rho * delta_eps) * st.q

        p_ = A @ p
        epsilon = inner(q, p_)
        beta = epsilon / nonzero(delta)

        v_ = p_ - beta * v
        y = Ml @ v_
        rho_new = _norm(y)

        w_ = A.rmatvec(q) - beta * w
        z = Mr.rmatvec(w_)
        xi = _norm(z)

        theta = rho_new / nonzero(st.gamma * torch.abs(beta))
        gamma = 1.0 / torch.sqrt(1.0 + theta**2)
        eta = -st.eta * st.rho * gamma**2 / nonzero(beta * st.gamma**2)

        coeff = (st.theta * gamma) ** 2
        d = eta * p + coeff * st.d
        s = eta * p_ + coeff * st.s

        x = st.x + d
        r = st.r - s
        return QmrState(
            x=x, r=r, v_=v_, y=y, w_=w_, z=z, p=p, q=q, d=d, s=s,
            rho=rho_new, xi=xi,
            gamma=gamma.to(rdtype),
            eta=eta.to(vdtype),
            theta=theta.to(rdtype),
            epsilon=epsilon.to(vdtype),
            resnorm=_norm(r),
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
