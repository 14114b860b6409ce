"""Pipelined (single-reduction) CG — Ghysels & Vanroose 2014 (counterpart
of ``krylov_tpu.solvers.pipelined``).

Standard CG has two sequentially dependent reductions per iteration
(``<p, Ap>``, then ``<r, M r>`` after the update).  The pipelined
recurrences carry the auxiliary vectors ``w = A u``, ``s = A p``,
``z = A q``, ``q = M w`` so that both scalars of an iteration
(``gamma = <r, u>``, ``delta = <w, u>``) and the residual norm come from
one fused reduction, and the matvec and preconditioner applications do not
depend on it.

The price is the textbook one: four more vectors, one extra
matvec-recurrence per iteration, and residual drift: the recurrence
residual slowly decouples from the true one, so every ``replace_every``
iterations all recurrence vectors are replaced with explicitly computed
ones (Cools et al. 2018).  The replacement tests the step number the
driver gives the step (:mod:`.._steps`): a host branch on the host, which
costs no device read, and on the graph route an IF node on the device
counter (the reference's ``lax.cond``), so it runs only where it fires.

``fused_inner`` (a stacked inner product over a tuple of vector pairs)
controls how the combined reduction is computed; by default it is one
``inner`` call per pair.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from ._common import nonzero, preconditioner, setup


class PipeCGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor  # residual (recurrence)
    u: torch.Tensor  # M r
    w: torch.Tensor  # A u
    p: torch.Tensor  # search direction
    s: torch.Tensor  # A p
    q: torch.Tensor  # M s
    z: torch.Tensor  # A q
    gamma: torch.Tensor
    alpha: torch.Tensor
    resnorm: torch.Tensor
    b: torch.Tensor  # the right-hand side, read by the replacement


def cg_pipelined(
    A,
    b,
    M=None,
    inner: Optional[Callable] = None,
    fused_inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    replace_every: int = 50,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Single-reduction pipelined CG for Hermitian positive definite A."""
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)

    if fused_inner is None:
        def fused_inner(pairs):
            return tuple(inner(a, c) for (a, c) in pairs)

    def explicit_state(x):
        r = b - A @ x
        u = M @ r
        w = A @ u
        gamma, rr = fused_inner(((r, u), (r, r)))
        gamma = ensure_real(gamma, "<r, M r>")
        rr = ensure_real(rr, "<r, r>")
        return r, u, w, gamma, torch.sqrt(rr)

    r0, u0, w0, gamma0, resnorm0 = explicit_state(x0)

    if callback is not None:
        callback(x0, r0)

    vdtype = torch.promote_types(u0.dtype, w0.dtype)
    zeros = torch.zeros(u0.shape, dtype=vdtype, device=b.device)
    state0 = PipeCGState(
        x=x0.to(vdtype),
        r=r0.to(vdtype),
        u=u0.to(vdtype),
        w=w0.to(vdtype),
        p=zeros, s=zeros, q=zeros, z=zeros,
        gamma=gamma0,
        alpha=torch.ones_like(gamma0),
        resnorm=resnorm0,
        b=b,
    )

    def step(st: PipeCGState, criterion, ctl) -> PipeCGState:
        # One fused reduction per iteration.  Besides the pipelined-CG
        # scalars gamma = <r,u> and delta = <w,u>, it carries the inner
        # products that let the post-update residual norm be recurred
        # without a second reduction:
        #   ||r - alpha*s||^2 = rr - 2 alpha Re<r,s> + alpha^2 <s,s>
        # with <r,s>, <s,s> expanded through s = w + beta*s_old.
        gamma, delta, rr, rw, rs_o, ww, ws_o, ss_o = fused_inner((
            (st.r, st.u), (st.w, st.u), (st.r, st.r), (st.r, st.w),
            (st.r, st.s), (st.w, st.w), (st.w, st.s), (st.s, st.s),
        ))
        gamma = ensure_real(gamma, "<r, M r>")
        delta = ensure_real(delta, "<w, M r>")
        # independent of the scalars above
        m = M @ st.w
        n = A @ m

        beta = ctl.pick(ctl.k == 0, lambda: torch.zeros_like(gamma),
                        lambda: gamma / nonzero(st.gamma))
        alpha = gamma / nonzero(delta - beta * gamma / nonzero(st.alpha))

        z = n + beta * st.z
        q = m + beta * st.q
        s = st.w + beta * st.s
        p = st.u + beta * st.p
        x = st.x + alpha * p
        r = st.r - alpha * s
        u = st.u - alpha * q
        w = st.w - alpha * z

        rs = rw.real + beta * rs_o.real
        ss = ww.real + 2.0 * beta * ws_o.real + beta * beta * ss_o.real
        rr_new = torch.clamp(rr.real - 2.0 * alpha * rs + alpha * alpha * ss, min=0.0)

        # periodic residual replacement (Cools et al. 2018): recompute all
        # recurrence vectors explicitly, r/u/w and the direction images
        # s = A p, q = M s, z = A q.  Refreshing only the residual chain
        # leaves the direction chain inconsistent and destabilizes the
        # recurrence instead of fixing it.  Written over the recurrence's
        # vectors, which are this step's own.  The right-hand side comes
        # from the state: a graph kept across solves (make_sharded_solver)
        # replays this step with another one.
        def replace():
            r.copy_(st.b - A @ x)
            u.copy_(M @ r)
            w.copy_(A @ u)
            s.copy_(A @ p)
            q.copy_(M @ s)
            z.copy_(A @ q)

        ctl.cond((ctl.k + 1) % replace_every == 0, replace)

        return PipeCGState(
            x=x, r=r, u=u, w=w, p=p, s=s, q=q, z=z,
            gamma=gamma, alpha=alpha,
            resnorm=torch.sqrt(rr_new), b=st.b,
        )

    method = Method(
        step=step,
        xk=lambda s, k: s.x,
        explicit_resnorm=lambda xk: explicit_state(xk)[4],
        callback_args=lambda s, k: (s.x, s.r),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
