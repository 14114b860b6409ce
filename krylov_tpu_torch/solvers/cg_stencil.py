"""Fused conjugate gradient for stencil operators (const- and
variable-coefficient).

Counterpart of ``krylov_tpu.solvers.cg_stencil`` for
:class:`ConstStencilOperator` and :class:`GridStencilOperator`.
Mathematically identical to :func:`cg` (same recurrence, division guards,
explicit-residual double-check), but with ``fused=True`` each float32
iteration runs as two fused kernels
(:mod:`krylov_tpu_torch.ops.cuda_stencil`):

  phase A (K3 const, K5 variable): ``p = r + omega p``, ``Ap = A p``, ``<p, Ap>``
  phase B (K4): ``y += alpha p``, ``r -= alpha Ap``, ``<r, r>``

cutting the per-iteration memory traffic from about 15N to 10N words on
the const operator, 19N to 15N at five coefficient planes.  With
``M="jacobi"`` the two phases are the Jacobi kernels, which stream the
``dinv = 1 / diag(A)`` plane as one more input each:

  phase A (K6): ``p = dinv r + omega p``, ``Ap = A p``, ``<p, Ap>``
  phase B (K7): ``y += alpha p``, ``r -= alpha Ap``, ``<r, dinv r>``

Phase A writes the new direction into the second of two ``p`` buffers (the
kernel reads neighbour rows of the old one); phase B updates ``y`` and
``r`` in place.  Unpreconditioned (both operators) or Jacobi-preconditioned
(:class:`GridStencilOperator`) CG on a single grid-shaped right-hand side.
"""

from typing import NamedTuple, Optional

import torch

from .. import _device
from .._driver import WHILE_LOOP, Method, run
from .._info import Info
from ..ops import cuda_stencil
from ..ops.stencil import ConstStencilOperator, GridStencilOperator
from ._common import initial_residual


class _FusedState(NamedTuple):
    y: torch.Tensor  # solution increment (xk = x0 + y)
    r: torch.Tensor
    p: torch.Tensor
    rho_old: torch.Tensor
    rho: torch.Tensor
    resnorm: torch.Tensor


def cg_stencil(
    A,
    b,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    fused: bool = False,
    M=None,
):
    """CG for :class:`ConstStencilOperator` / :class:`GridStencilOperator`
    on grid vectors.

    ``fused=True`` runs the two fused kernels per iteration for float32
    vectors (other dtypes take the unfused composition, as in the
    reference).  ``M="jacobi"`` (GridStencilOperator only) runs diagonally
    preconditioned CG with the recurrence and resnorm convention
    (``sqrt(<r, M r>)``) of :func:`cg` with ``M=DiagonalOperator(1/diag)``;
    with ``fused=True`` its float32 iterations run the two Jacobi kernels.
    A ``b`` that carries no device (a numpy array) goes to ``A.device``.
    """
    if isinstance(A, ConstStencilOperator):
        const = True
    elif isinstance(A, GridStencilOperator):
        const = False
    else:
        raise TypeError(
            "cg_stencil requires a ConstStencilOperator or GridStencilOperator"
        )
    b = _device.as_tensor(b, A.device)
    Mg, ny = A.grid
    flat_in = b.ndim == 1
    b2 = b.reshape(Mg, ny) if flat_in else b
    if tuple(b2.shape) != (Mg, ny):
        raise ValueError("cg_stencil supports a single grid-shaped RHS")
    maxiter = Mg * ny if maxiter is None else maxiter
    # the fused kernels accumulate in the vector dtype; bf16 CG iterations
    # are numerically meaningless, so gate on f32 as the reference does
    use_fused = fused and b2.dtype == torch.float32

    if M is None:
        dinv2 = None
    elif M == "jacobi":
        if const:
            raise ValueError(
                "M='jacobi' requires a GridStencilOperator (a constant-"
                "coefficient Jacobi preconditioner is a scalar scaling)"
            )
        d = A.diagonal().reshape(Mg, ny).to(b2.dtype)
        dinv2 = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 1.0)
    else:
        raise ValueError("cg_stencil supports M=None or M='jacobi'; use "
                         "krylov_tpu_torch.cg for general preconditioners")

    def mnorm2(r):
        return torch.sum(r * r) if dinv2 is None else torch.sum(r * (dinv2 * r))

    x02 = (torch.zeros_like(b2) if x0 is None
           else _device.as_tensor(x0, b2.device).reshape(Mg, ny))
    # x0 = 0 short-circuit: r0 = b - A@0 == b bitwise; the copy keeps the
    # in-place phase B off the caller's b
    r0 = initial_residual(A, b2, x02, x0 is None).clone()
    rho0 = mnorm2(r0)

    state0 = _FusedState(
        y=torch.zeros_like(r0),
        r=r0,
        p=torch.zeros_like(r0),
        rho_old=torch.ones_like(rho0),
        rho=rho0,
        resnorm=torch.sqrt(rho0),
    )
    # phase A's second direction buffer and its Ap output, reused each step
    p_spare = torch.empty_like(r0)
    ap_buf = torch.empty_like(r0)

    def step(s: _FusedState, criterion) -> _FusedState:
        nonlocal p_spare
        omega = s.rho / torch.where(s.rho_old != 0, s.rho_old, 1.0)
        if use_fused and const:
            p, Ap, pAp = cuda_stencil.cg_fused_phase_a(
                omega, s.r, s.p, A.kernel_bands, out=(p_spare, ap_buf),
            )
            p_spare = s.p
        elif use_fused and dinv2 is not None:
            p, Ap, pAp = cuda_stencil.cg_fused_phase_a_var_jac(
                omega, s.r, s.p, A.coeffs2d, dinv2, A.row_offsets, A.col_offsets,
                out=(p_spare, ap_buf),
            )
            p_spare = s.p
        elif use_fused:
            p, Ap, pAp = cuda_stencil.cg_fused_phase_a_var(
                omega, s.r, s.p, A.coeffs2d, A.row_offsets, A.col_offsets,
                out=(p_spare, ap_buf),
            )
            p_spare = s.p
        else:
            z = s.r if dinv2 is None else dinv2 * s.r
            p = z + omega * s.p
            Ap = A @ p
            pAp = torch.sum(p * Ap)
        alpha = s.rho / torch.where(pAp != 0, pAp, 1.0)
        if use_fused and dinv2 is not None:
            y, r, rho_new = cuda_stencil.cg_fused_phase_b_jac(
                alpha, s.y, s.r, p, Ap, dinv2)
        elif use_fused:
            y, r, rho_new = cuda_stencil.cg_fused_phase_b(alpha, s.y, s.r, p, Ap)
        else:
            y = s.y + alpha * p
            r = s.r - alpha * Ap
            rho_new = mnorm2(r)
        return _FusedState(
            y=y, r=r, p=p, rho_old=s.rho, rho=rho_new,
            resnorm=torch.sqrt(rho_new),
        )

    def xk_of(s: _FusedState):
        return x02 + s.y

    def explicit_resnorm(xk):
        return torch.sqrt(mnorm2(b2 - (A @ xk)))

    # capturable: every fused phase writes into buffers of its own, and
    # p_spare alternates between two, so a graph of an even number of steps
    # starts each replay with the direction back in its first buffer and
    # copies nothing back for it
    method = Method(step=step, xk=xk_of, explicit_resnorm=explicit_resnorm,
                    capturable=True, even_steps=use_fused)
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter, backend=WHILE_LOOP,
    )

    xk = xk_of(state)
    if flat_in:
        xk = xk.reshape(-1)
    num_operations = {
        "A": 1 + k, "M": 2 + k, "Ml": 2 + k, "Mr": 1 + k,
        "inner": 2 + 2 * k, "axpy": 2 + 2 * k,
    }
    info = Info(success, xk, k, resnorms, num_operations, None)
    return (xk if success else None), info
