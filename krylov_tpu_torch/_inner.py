"""Inner products and norms.

A 1-D right-hand side uses a conjugated dot product; an ``(N, k)``
right-hand side contracts only the leading axis, so every downstream scalar
(alpha, beta, resnorm, ...) becomes a ``(k,)`` tensor and all columns iterate
together (counterpart of ``krylov_tpu._inner``).
"""

import torch


def get_default_inner(b_shape):
    """Return the Euclidean inner product matching the RHS shape.

    ``inner(x, y) == sum_i conj(x_i) * y_i`` contracted over axis 0 only, so
    the result has shape ``b_shape[1:]``.  Mixed dtypes promote as in
    elementwise arithmetic.
    """

    def inner(x, y):
        return torch.sum(x.conj() * y, dim=0)

    return inner


def ensure_real(x2, what="<x, M x>"):
    """Drop the imaginary part of an inner-product value, after checking it.

    The check is relative, as in the reference package: raise when
    ``|imag| > sqrt(eps) * (1 + |value|)``.  Complex products rounded through
    FMAs leave eps-level imaginary residue that an exact ``imag != 0`` test
    would reject.
    """
    if x2.is_complex():
        tol = torch.finfo(x2.dtype).eps ** 0.5
        if bool(torch.any(x2.imag.abs() > tol * (1.0 + x2.abs()))):
            raise ValueError(f"inner product {what} gave nonzero imaginary part")
        return x2.real
    return x2
