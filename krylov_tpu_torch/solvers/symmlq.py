"""SYMMLQ for symmetric (possibly indefinite) systems (counterpart of
``krylov_tpu.solvers.symmlq``).

Self-contained Lanczos + LQ factorization with a two-deep scalar Givens
history, optional ``M`` preconditioner, arbitrary inner product, CG-point
extraction for the returned iterate.

The two-deep ``c/s/ceta`` history is scalar state shifted by assignment.
The k == 0 special cases test the step number the driver gives the step,
not data (:mod:`.._steps`): a host branch on the host, which costs no
device read, and a ``torch.where`` on the device counter of the graph
route, as in the reference's compiled loop.  As in the
reference, ``ceta`` starts at 0 (a zero right-hand side converges at k = 0
with the CG point degenerating to ``x``) and the ``beta`` divisions are
guarded.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import inner_tail, nonzero, preconditioner, setup


class SymmlqState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    u_old: torch.Tensor
    v_old: torch.Tensor
    w: torch.Tensor
    w_bar: torch.Tensor
    beta: torch.Tensor
    c_cur: torch.Tensor
    c_last: torch.Tensor
    s_cur: torch.Tensor
    s_last: torch.Tensor
    ceta_cur: torch.Tensor
    ceta_last: torch.Tensor
    ceta_last2: torch.Tensor
    resnorm: torch.Tensor
    # the first Lanczos norm: in the state, so that a graph kept across
    # solves (make_sharded_solver) reads the solve's own
    beta1: torch.Tensor


def symmlq(
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

    r_init = b if x0_default else b - A @ x0

    if callback is not None:
        callback(x0, r_init)

    resnorm0 = _norm(r_init)

    z_init = M @ r_init
    dp = inner(r_init, z_init)
    beta1 = torch.sqrt(dp)
    safe_beta = nonzero(beta1)

    v_init = r_init / safe_beta
    u_init = z_init / safe_beta

    vdtype = u_init.dtype
    tail = inner_tail(inner, b)
    sdtype = dp.dtype
    zeros_v = torch.zeros(b.shape, dtype=vdtype, device=b.device)

    def scal(val):
        return torch.full(tail, val, dtype=sdtype, device=b.device)

    state0 = SymmlqState(
        x=x0.to(vdtype),
        r=r_init.to(vdtype),
        z=z_init,
        u=u_init,
        v=v_init,
        u_old=zeros_v,
        v_old=zeros_v,
        w=zeros_v,
        w_bar=u_init,
        beta=beta1 * scal(1.0),
        c_cur=scal(1.0),
        c_last=scal(1.0),
        s_cur=scal(0.0),
        s_last=scal(0.0),
        ceta_cur=scal(0.0),
        ceta_last=scal(0.0),
        ceta_last2=scal(0.0),
        resnorm=resnorm0,
        beta1=beta1,
    )

    def step(s: SymmlqState, criterion, ctl) -> SymmlqState:
        first = ctl.k == 0

        def shift():  # the basis and solution shift, skipped at k == 0
            inv_b = 1.0 / nonzero(s.beta)
            v = s.r * inv_b
            u = s.z * inv_b
            w = s.c_cur * s.w_bar + s.s_cur * u
            w_bar = -s.s_cur * s.w_bar + s.c_cur * u
            x = s.x + s.ceta_cur * w
            return s.v, s.u, v, u, w, w_bar, x, s.ceta_last, s.ceta_cur

        v_old, u_old, v, u, w, w_bar, x, ceta_last2, ceta_last = ctl.pick(
            first, lambda: (s.v_old, s.u_old, s.v, s.u, s.w, s.w_bar, s.x, s.ceta_last2,
                            s.ceta_last), shift)

        # Lanczos
        r = A @ u
        alpha = inner(u, r)
        z = M @ r
        r = r - alpha * v - s.beta * v_old
        z = z - alpha * u - s.beta * u_old

        beta_old = s.beta
        beta_new = torch.sqrt(inner(r, z))

        # LQ factorization update
        c_last2, c_last = s.c_last, s.c_cur
        s_last2, s_last = s.s_last, s.s_cur
        gamma_bar = c_last * alpha - c_last2 * s_last * beta_old
        gamma = torch.sqrt(gamma_bar * gamma_bar + beta_new * beta_new)
        delta = s_last * alpha + c_last2 * c_last * beta_old
        epsilon = s_last2 * beta_old

        c_cur = gamma_bar / gamma
        s_cur = beta_new / gamma

        ceta_cur = ctl.pick(
            first, lambda: (s.beta1 / gamma).to(sdtype),
            lambda: (-(delta * ceta_last + epsilon * ceta_last2) / gamma).to(sdtype))

        return SymmlqState(
            x=x,
            r=r,
            z=z,
            u=u,
            v=v,
            u_old=u_old,
            v_old=v_old,
            w=w,
            w_bar=w_bar,
            beta=beta_new.to(s.beta.dtype),
            c_cur=c_cur.to(sdtype),
            c_last=c_last,
            s_cur=s_cur.to(sdtype),
            s_last=s_last,
            ceta_cur=ceta_cur,
            ceta_last=ceta_last,
            ceta_last2=ceta_last2,
            resnorm=_norm(r),
            beta1=s.beta1,
        )

    def xout_of(s: SymmlqState):
        # move to the CG point
        ceta_bar = s.ceta_cur / torch.where(s.c_cur != 0.0, s.c_cur, 1.0e-15)
        return s.x + ceta_bar * s.w_bar

    method = Method(
        step=step,
        xk=lambda s, k: xout_of(s),
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s, k: (xout_of(s), s.r),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    xout = xout_of(state)
    return (xout if success else None), Info(success, xout, k, resnorms)
