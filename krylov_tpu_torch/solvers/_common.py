"""Shared solver preamble (counterpart of ``krylov_tpu.solvers._common``).

Uniform argument handling for every method: RHS coercion, square-shape
checks, operator normalization, default inner product, default zero initial
guess, ``maxiter=None -> N``.  Every tensor the solve makes lives on the
right-hand side's device.
"""

import torch

from .._inner import get_default_inner
from .._operators import Identity, as_operator


def setup(A, b, x0=None, inner=None, maxiter=None):
    b = torch.as_tensor(b)
    A = as_operator(A, device=b.device)
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
        inner = get_default_inner(b.shape) if inner is None else inner
    maxiter = N if maxiter is None else maxiter
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
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
    if M is None:
        return Identity()
    return as_operator(M, device=device)
