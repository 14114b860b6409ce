"""Preconditioned MINRES (counterpart of ``krylov_tpu.solvers.minres``).

``M``/``Ml``/``Mr`` preconditioning, arbitrary inner product, multi-RHS,
callback, ``num_operations`` model.

The three-term Lanczos recurrence and the Givens-QR update of the
tridiagonal are inlined functionally in :class:`MinresState`.  The two
stored rotations start as *identity* rotations, so applying them at k < 2
is an exact no-op and the hot loop has no host branch; the rotations are
generated on the device (:mod:`krylov_tpu_torch.givens`), so a step reads
nothing back.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Product
from ..givens import apply_givens, givens
from ._common import initial_residual, inner_tail, nonzero, preconditioner, setup


class MinresState(NamedTuple):
    yk: torch.Tensor
    W0: torch.Tensor
    W1: torch.Tensor
    lan_v: torch.Tensor
    lan_p: torch.Tensor
    lan_p_old: torch.Tensor
    lan_beta: torch.Tensor  # previous Lanczos subdiagonal (real)
    G1: torch.Tensor  # last Givens rotation (2, 2, *tail)
    G2: torch.Tensor  # second-to-last Givens rotation
    y: torch.Tensor  # rotated rhs 2-vector of the projected system
    resnorm: torch.Tensor


def _identity_rotation(tail, dtype, device):
    eye = torch.eye(2, dtype=dtype, device=device)
    return eye.reshape((2, 2) + (1,) * len(tail)).expand((2, 2) + tail).clone()


def minres(
    A,
    b,
    M=None,
    Ml=None,
    Mr=None,
    inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)
    Ml = preconditioner(Ml, b.device)
    Mr = preconditioner(Mr, b.device)
    Ml_A_Mr = Product(Ml, A, Mr)

    tail = inner_tail(inner, b)

    def residual_norm(z):
        Ml_r = Ml @ (b - A @ z)
        return torch.sqrt(ensure_real(inner(Ml_r, M @ Ml_r), "<x, M x>"))

    r0 = initial_residual(A, b, x0, x0_default)
    Ml_r0 = Ml @ r0
    M_Ml_r0 = M @ Ml_r0
    norm0 = torch.sqrt(ensure_real(inner(Ml_r0, M_Ml_r0), "<x, M x>"))

    vdtype = M_Ml_r0.dtype
    rdtype = norm0.dtype

    if callback is not None:
        callback(x0, norm0)

    safe0 = nonzero(norm0)
    zeros_v = torch.zeros(b.shape, dtype=vdtype, device=b.device)
    state0 = MinresState(
        yk=zeros_v,
        W0=zeros_v,
        W1=zeros_v,
        lan_v=M_Ml_r0 / safe0,
        lan_p=Ml_r0 / safe0,
        lan_p_old=zeros_v,
        lan_beta=torch.zeros(tail, dtype=rdtype, device=b.device),
        G1=_identity_rotation(tail, rdtype, b.device),
        G2=_identity_rotation(tail, rdtype, b.device),
        y=torch.stack([norm0, torch.zeros_like(norm0)]),
        resnorm=norm0,
    )

    def step(s: MinresState, criterion) -> MinresState:
        v = s.lan_v

        # --- Lanczos: one three-term recurrence step ------------------------
        Av = Ml_A_Mr @ v
        h0 = s.lan_beta  # previous subdiagonal moves to the superdiagonal
        Av = Av - h0 * s.lan_p_old
        alpha = inner(v, Av)
        Av = Av - alpha * s.lan_p
        MAv = M @ Av
        beta = torch.sqrt(ensure_real(inner(Av, MAv), "<v, M v>"))
        safe_beta = nonzero(beta)

        # Lanczos coefficients are real for self-adjoint operators
        alpha_r = ensure_real(alpha, "Lanczos <v, Av> (is A self-adjoint?)")

        # --- implicit QR update of the tridiagonal via stored rotations ----
        R01 = apply_givens(s.G2, torch.stack([torch.zeros_like(h0), h0]))
        R12 = apply_givens(s.G1, torch.stack([R01[1], alpha_r.to(rdtype)]))
        G_new, r = givens(torch.stack([R12[1], beta.to(rdtype)]))
        R0, R1, R2 = R01[0], R12[0], r

        y_rot = apply_givens(G_new, s.y)

        # --- solution update (the two axpys dominating the iteration) ------
        z = (v - R0 * s.W0 - R1 * s.W1) / nonzero(R2)
        yk = s.yk + y_rot[0] * z

        return MinresState(
            yk=yk,
            W0=s.W1,
            W1=z,
            lan_v=MAv / safe_beta,
            lan_p=Av / safe_beta,
            lan_p_old=s.lan_p,
            lan_beta=beta,
            G1=G_new.to(s.G1.dtype),
            G2=s.G1,
            y=torch.stack([y_rot[1], torch.zeros_like(y_rot[1])]),
            resnorm=torch.abs(y_rot[1]),
        )

    def xk_of(s: MinresState):
        return x0 + Mr @ s.yk

    method = Method(
        step=step,
        xk=xk_of,
        explicit_resnorm=residual_norm,
        callback_args=lambda s: (xk_of(s), s.resnorm),
        capturable=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )

    xk = xk_of(state)
    num_operations = {
        "A": 1 + k,
        "M": 2 + k,
        "Ml": 2 + k,
        "Mr": 1 + k,
        "inner": 2 + 2 * k,
        "axpy": 4 + 8 * k,
    }
    return (xk if success else None), Info(success, xk, k, resnorms, num_operations)
