"""Block CG (O'Leary 1980): one Krylov space shared by all right-hand-side
columns (counterpart of ``krylov_tpu.solvers.block``).

The blocked solves of the other methods iterate each column independently.
Block CG searches the union of the columns' spaces: per iteration one
blocked product ``A @ P`` (an ``(N, k)`` sparse product) and two k-by-k
matrix inner products replace k scalar recurrences, and convergence is
governed by the (k-1)-deflated spectrum, so ill-conditioned systems
converge in substantially fewer iterations than column-wise CG.

The k-by-k Gram solves are small dense solves on the device, outside any
kernel (``torch.linalg.solve_ex``, which reads nothing back), in float64
for float32 vectors: the solve is the error amplifier of the block
recurrences and k is tiny.  Near-converged columns make the direction Gram
matrix ill-conditioned; a relative ridge keeps the solves stable (the
residual criterion is still checked per column).

``block_inner(U, V) -> (k, k)`` replaces the default contraction over all
vector axes.  The periodic replacement tests the step number the driver
gives the step (:mod:`.._steps`): a host branch on the host, an IF node on
the device counter on the graph route (the reference's ``lax.cond``).
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._operators import Identity
from ._common import preconditioner, setup


class BlockCGState(NamedTuple):
    X: torch.Tensor  # (N, k) iterate offset from x0
    R: torch.Tensor  # (N, k) residuals
    Z: torch.Tensor  # (N, k) preconditioned residuals
    P: torch.Tensor  # (N, k) search directions
    gamma: torch.Tensor  # (k, k) R^H Z
    resnorm: torch.Tensor  # (k,), or () for a 1-D right-hand side
    B: torch.Tensor  # the right-hand sides and the first iterate, read by
    X0: torch.Tensor  # the replacement


def _default_block_inner(U, V):
    # contract over all leading (vector) axes; trailing axis = RHS columns
    return torch.einsum("...k,...l->kl", U.conj(), V)


def _ridge_solve(Gram, RHS):
    """Solve ``Gram @ Y = RHS`` with a relative ridge for near-singular Gram.

    The ridge scales with the Gram itself: near convergence its entries are
    about resnorm^2, and any absolute floor would swamp them and stall the
    recurrence at a spurious accuracy floor; eps scales with the working
    precision."""
    k = Gram.shape[0]
    scale = torch.trace(Gram).real / k
    eps = 10.0 * k * torch.finfo(Gram.real.dtype).eps
    ridge = torch.where(scale > 0, scale, 1.0) * eps
    eye = torch.eye(k, dtype=Gram.dtype, device=Gram.device)
    return torch.linalg.solve_ex(Gram + ridge * eye, RHS, check_errors=False)[0]


def _gram_solve(Gram, RHS):
    """The Gram solve, in float64 for float32 (complex128 for complex64)."""
    if Gram.dtype in (torch.float32, torch.complex64):
        wide = torch.complex128 if Gram.is_complex() else torch.float64
        return _ridge_solve(Gram.to(wide), RHS.to(wide)).to(RHS.dtype)
    return _ridge_solve(Gram, RHS)


def cg_block(
    A,
    b,
    M=None,
    inner: Optional[Callable] = None,
    block_inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    replace_every: int = 150,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Block CG for Hermitian positive definite ``A`` with ``b`` of shape
    ``(N, k)`` (a 1-D ``b`` degenerates to standard CG recurrences).

    ``replace_every``: every that many iterations the residual block is
    recomputed explicitly and the direction block restarted; block
    recurrences lose orthogonality faster than single-vector CG."""
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)
    unpreconditioned = isinstance(M, Identity)
    # vector shape: operator-native (e.g. grid (M, ny)) or flat (N,);
    # anything beyond it is the RHS column axis
    vshape = getattr(A, "vector_shape", None)
    if vshape is not None and tuple(b.shape[: len(vshape)]) == tuple(vshape):
        vdims = len(vshape)
    else:
        vdims = 1
    squeeze = b.ndim == vdims
    B = b[..., None] if squeeze else b
    X0 = x0[..., None] if squeeze else x0
    if block_inner is None:
        block_inner = _default_block_inner

    def residuals(X):
        return B - A @ X

    def column_norms2(R, gamma):
        # Euclidean per-column residual norms; free when M is the identity
        # (Z == R), one extra contraction otherwise
        g = gamma if unpreconditioned else block_inner(R, R)
        return torch.abs(torch.diagonal(g))

    def columns(v):
        return v[..., 0] if squeeze else v

    R0 = residuals(X0)
    Z0 = M @ R0
    gamma0 = block_inner(R0, Z0)
    resnorm0 = torch.sqrt(torch.abs(torch.diagonal(block_inner(R0, R0))))

    if callback is not None:
        callback(x0, columns(R0))

    vdtype = torch.promote_types(Z0.dtype, R0.dtype)
    state0 = BlockCGState(
        X=torch.zeros(B.shape, dtype=vdtype, device=b.device),
        R=R0.to(vdtype),
        Z=Z0.to(vdtype),
        P=Z0.to(vdtype),
        gamma=gamma0,
        resnorm=columns(resnorm0),
        B=B, X0=X0,
    )

    def step(st: BlockCGState, criterion, ctl) -> BlockCGState:
        Q = A @ st.P
        delta = block_inner(st.P, Q)  # (k, k), one reduction
        alpha = _gram_solve(delta, st.gamma)
        X = st.X + st.P @ alpha
        R = st.R - Q @ alpha
        Z = M @ R
        gamma_new = block_inner(R, Z)  # (k, k), one reduction
        beta = _gram_solve(st.gamma, gamma_new)
        P = Z + st.P @ beta

        # periodic explicit replacement: the explicit residual and P reset
        # to Z; the conjugacy chain (P against gamma) is where f32 drift
        # lives, so a kept P after refreshing gamma diverges.  Written over
        # this step's own R, Z, P and gamma.  B and X0 come from the state:
        # a graph kept across solves (make_sharded_solver) replays this
        # step with other ones.
        def replace():
            R.copy_(st.B - A @ (st.X0 + X))
            Z.copy_(M @ R)
            P.copy_(Z)
            gamma_new.copy_(block_inner(R, Z))

        ctl.cond((ctl.k + 1) % replace_every == 0, replace)

        return BlockCGState(
            X=X, R=R, Z=Z, P=P, gamma=gamma_new,
            resnorm=columns(torch.sqrt(column_norms2(R, gamma_new))), B=st.B, X0=st.X0,
        )

    def xk_of(st: BlockCGState):
        return columns(X0 + st.X)

    def explicit_resnorm(xk):
        Rx = residuals(xk[..., None] if squeeze else xk)
        return columns(torch.sqrt(torch.abs(torch.diagonal(block_inner(Rx, Rx)))))

    method = Method(
        step=step,
        xk=lambda st, k: xk_of(st),
        explicit_resnorm=explicit_resnorm,
        callback_args=lambda st, k: (xk_of(st), columns(st.R)),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    xk = xk_of(state)
    return (xk if success else None), Info(success, xk, k, resnorms)
