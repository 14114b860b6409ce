"""Inner products and norms.

A 1-D right-hand side uses a conjugated dot product; an ``(N, k)``
right-hand side contracts only the leading axis, so every downstream scalar
(alpha, beta, resnorm, ...) becomes a ``(k,)`` tensor and all columns iterate
together (counterpart of ``krylov_tpu._inner``).
"""

import contextlib
import threading

import torch

_HOST_CHECKS = threading.local()  # .off: this thread's steps skip host reads


def get_default_inner(b_shape):
    """Return the Euclidean inner product matching the RHS shape.

    ``inner(x, y) == sum_i conj(x_i) * y_i`` contracted over axis 0 only, so
    the result has shape ``b_shape[1:]``.  Mixed dtypes promote as in
    elementwise arithmetic.
    """

    def inner(x, y):
        return torch.sum(x.conj() * y, dim=0)

    return inner


def as_inner(inner, b_shape):
    """``inner`` with values as tensors on the vectors' device (a
    numpy-based user inner returns arrays); the default Euclidean inner for
    ``b_shape`` when ``inner`` is None."""
    if inner is None:
        return get_default_inner(b_shape)

    def wrapped(x, y):
        v = inner(x, y)
        if isinstance(v, torch.Tensor) and v.device == x.device:
            return v
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            # a copy from the host cannot be captured into a CUDA graph
            raise RuntimeError(f"inner returned a {type(v).__name__} on the host inside a "
                               "captured step; return a tensor on the vectors' device")
        return torch.as_tensor(v, device=x.device)

    return wrapped


def ensure_real(x2, what="<x, M x>"):
    """Drop the imaginary part of an inner-product value, after checking it.

    The check is relative, as in the reference package: raise when
    ``|imag| > sqrt(eps) * (1 + |value|)``.  Complex products rounded through
    FMAs leave eps-level imaginary residue that an exact ``imag != 0`` test
    would reject.

    The check is skipped, as the reference skips it under tracing, where it
    would read the value on the host: while the current CUDA stream is
    capturing a graph, and within :func:`host_checks_off` (the step the
    ``while_loop`` graph route runs from the host just before its capture).
    """
    if x2.is_complex():
        if getattr(_HOST_CHECKS, "off", False) or (
                torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            return x2.real
        tol = torch.finfo(x2.dtype).eps ** 0.5
        if bool(torch.any(x2.imag.abs() > tol * (1.0 + x2.abs()))):
            raise ValueError(f"inner product {what} gave nonzero imaginary part")
        return x2.real
    return x2


@contextlib.contextmanager
def host_checks_off():
    """Within: this thread's :func:`ensure_real` reads nothing on the host
    (a step that a CUDA graph will replay must not)."""
    prev = getattr(_HOST_CHECKS, "off", False)
    _HOST_CHECKS.off = True
    try:
        yield
    finally:
        _HOST_CHECKS.off = prev
