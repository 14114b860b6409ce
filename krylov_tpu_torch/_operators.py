"""Operator layer (L0).

Structural typing for anything applied with ``@`` plus a small zoo of
concrete operators (counterpart of ``krylov_tpu._operators``).  Every
concrete operator holds its tensors on one explicit device; ``rmatvec``
(adjoint matvec) is provided functionally instead of via cached transposed
copies.  Sparse (scipy / PET / BSR) routing is not ported yet.
"""

import functools

import numpy as np
import torch


class Identity:
    """No-op operator, default preconditioner.

    dtype is ``uint8`` so it never widens the common dtype of a product.
    """

    dtype = torch.uint8

    def __matmul__(self, x):
        return x

    matvec = __matmul__

    def rmatvec(self, x):
        return x


class Product:
    """Lazy operator composition, applied right-to-left.

    ``Product(Ml, A, Mr) @ x == Ml @ (A @ (Mr @ x))``.
    """

    def __init__(self, *operators):
        self.operators = operators
        self.dtype = functools.reduce(
            torch.promote_types, (op.dtype for op in operators)
        )

    def __matmul__(self, x):
        out = x
        for op in self.operators[::-1]:
            out = op @ out
        return out


class MatrixOperator:
    """Dense-matrix operator backed by a tensor.

    The matvec is ``torch.matmul``; the adjoint matvec is ``A^H @ x`` with no
    cached adjoint copy.
    """

    def __init__(self, a):
        self.a = a

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def shape(self):
        return tuple(self.a.shape)

    def __matmul__(self, x):
        return torch.matmul(self.a, x)

    matvec = __matmul__

    def rmatvec(self, x):
        """y = A^H @ x."""
        return torch.matmul(self.a.mH, x)

    def diagonal(self):
        return torch.diagonal(self.a)


class DiagonalOperator:
    """Diagonal operator ``diag(d)`` — the Jacobi preconditioner shape.

    Elementwise multiply, so it works with any vector shape (flat,
    multi-RHS, grid-shaped).
    """

    def __init__(self, d):
        self.d = d

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def shape(self):
        n = self.d.numel()
        return (n, n)

    def _expand(self, d, x):
        # multi-RHS trailing dims broadcast against the diagonal
        return d.reshape(tuple(d.shape) + (1,) * (x.ndim - d.ndim))

    def __matmul__(self, x):
        return self._expand(self.d, x) * x

    matvec = __matmul__

    def rmatvec(self, x):
        return self._expand(self.d.conj(), x) * x

    def diagonal(self):
        return self.d.reshape(-1)


def jacobi_preconditioner(A):
    """``M = diag(A)^-1`` as a :class:`DiagonalOperator` (guarding zeros)."""
    d = A.diagonal() if hasattr(A, "diagonal") else torch.diagonal(A)
    return DiagonalOperator(torch.where(d != 0, 1.0 / d, 1.0))


class CallableOperatorWrapper:
    """Wraps an arbitrary object that implements ``__matmul__``.

    ``rmatvec`` delegates if available, otherwise applies the object's
    conjugate transpose.  The dtype is the object's own, or float64.
    """

    def __init__(self, obj):
        self._obj = obj
        self._adj = None
        self.shape = getattr(obj, "shape", None)
        dt = getattr(obj, "dtype", None)
        if dt is not None and not isinstance(dt, torch.dtype):
            dt = torch.from_numpy(np.zeros(0, dt)).dtype
        self.dtype = torch.float64 if dt is None else dt

    def __matmul__(self, x):
        return self._obj @ x

    matvec = __matmul__

    def rmatvec(self, x):
        if hasattr(self._obj, "rmatvec"):
            return self._obj.rmatvec(x)
        if self._adj is None:
            self._adj = self._obj.T.conj()
        return self._adj @ x

    def diagonal(self):
        return self._obj.diagonal()


def as_operator(A, device=None):
    """Normalize anything with ``@`` into an operator this library can drive.

    * tensors and ndarrays -> :class:`MatrixOperator` on ``device`` (the
      tensor's own device when ``None``),
    * objects already exposing ``rmatvec`` are used as-is,
    * any other object with ``__matmul__`` is wrapped.
    """
    if isinstance(A, (torch.Tensor, np.ndarray)):
        return MatrixOperator(torch.as_tensor(A, device=device))
    if hasattr(A, "tocsr"):
        raise NotImplementedError(
            "scipy sparse operators are not ported yet (ROADMAP Queue 1, "
            "general sparsity)"
        )
    if hasattr(A, "rmatvec"):
        return A
    if not hasattr(A, "__matmul__"):
        raise ValueError(f"Unknown linear operator A = {A}")
    return CallableOperatorWrapper(A)
