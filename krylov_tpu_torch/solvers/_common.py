"""Shared solver preamble (counterpart of ``krylov_tpu.solvers._common``).

Uniform argument handling for every method: RHS coercion, square-shape
checks, operator normalization, default inner product, default zero initial
guess, ``maxiter=None -> N``.  Every tensor the solve makes lives on the
right-hand side's device.  A right-hand side that carries no device (a
numpy array, a list) goes to the operator's device where the operator holds
tensors, else to the package's default device (:mod:`.._device`).
"""

import torch

from .. import _device
from .._inner import as_inner
from .._operators import Identity, as_operator


def setup(A, b, x0=None, inner=None, maxiter=None, needs_rmatvec=False):
    b = _device.as_tensor(b, _device.device_of(A))
    A = as_operator(A, device=b.device)
    if needs_rmatvec and hasattr(A, "ensure_adjoint"):
        # two-sided solvers build a lazy adjoint up front, on the host
        A.ensure_adjoint()
    if len(A.shape) != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got shape {A.shape}")
    N = A.shape[0]
    # operators may declare a native (non-flat) vector space, e.g. the
    # grid-shaped (M, ny) vectors of GridStencilOperator; such solves need
    # an explicit full-contraction inner
    vec_shape = getattr(A, "vector_shape", None)
    if vec_shape is not None and tuple(b.shape[: len(vec_shape)]) == tuple(
        vec_shape
    ):
        if inner is None:
            raise ValueError(
                "operator-native vector shapes require an explicit inner"
            )
    else:
        if A.shape[1] != b.shape[0]:
            raise ValueError(f"A {A.shape} does not match b {tuple(b.shape)}")
        inner = as_inner(inner, b.shape)
    maxiter = N if maxiter is None else maxiter
    x0 = torch.zeros_like(b) if x0 is None else _device.as_tensor(x0, b.device)
    return A, b, x0, N, inner, maxiter


def initial_residual(A, b, x0, x0_is_default):
    """``r0 = b - A @ x0``, short-circuited for the default zero guess.

    With ``x0_is_default`` the matvec is skipped: ``A @ 0`` sums
    ``c * 0 = +0.0`` exactly and ``b - 0.0 == b`` for every float, so the
    values are bitwise identical and the solve launches one operator kernel
    fewer.  The dtype is the one the real computation would produce,
    ``torch.promote_types(b.dtype, A.dtype)``; an operator without a torch
    dtype pays the real matvec.  The result may share ``b``'s storage.
    """
    dt = getattr(A, "dtype", None)
    if not x0_is_default or not isinstance(dt, torch.dtype):
        return b - A @ x0
    return b.to(torch.promote_types(b.dtype, dt))


def preconditioner(M, device=None):
    """``M`` as an operator (``device`` for a matrix that carries none; the
    default device when None), the identity for None."""
    if M is None:
        return Identity()
    return as_operator(M, device=device)


def inner_tail(inner, v):
    """Shape of the per-RHS scalars, the shape of ``inner(v, v)``: ``b.shape[1:]``
    for the default inner, ``()`` for a full-contraction inner on
    operator-native (grid-shaped) vectors."""
    return tuple(inner(v, v).shape)


def nonzero(t):
    """Breakdown-safe denominator: ``t`` with its zeros replaced by one, on
    the device (the library's where-guard convention)."""
    return torch.where(t != 0, t, 1.0)
