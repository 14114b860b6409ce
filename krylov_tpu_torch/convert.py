"""Carry operators across from numpy or from the reference package.

``from_reference`` duck-types the reference package's operators through
``np.asarray`` on their array attributes, so this module imports neither
JAX nor the reference package.  ``np.asarray`` of a JAX array is read-only,
and the port writes some buffers in place, so every array is copied before
it becomes a tensor.
"""

import numpy as np
import torch

from ._operators import DiagonalOperator, MatrixOperator
from .ops.stencil import BandedOperator, GridStencilOperator


def _tensor(arr, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native twin
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def grid_stencil_from_numpy(coeffs2d, offsets, ny, hermitian=False, device=None):
    """A :class:`GridStencilOperator` from ``(ndiag, M, ny)`` (or flat
    ``(ndiag, N)``) coefficients and flat band offsets."""
    return GridStencilOperator(
        _tensor(coeffs2d, device), offsets, ny, hermitian=hermitian
    )


def from_reference(op, device=None):
    """The port's twin of a reference ``GridStencilOperator``,
    ``BandedOperator``, ``MatrixOperator`` or ``DiagonalOperator``."""
    if hasattr(op, "coeffs2d") and hasattr(op, "ny"):
        return grid_stencil_from_numpy(
            op.coeffs2d, op.offsets, op.ny, hermitian=op.hermitian, device=device
        )
    if hasattr(op, "coeffs") and hasattr(op, "offsets"):
        return BandedOperator(
            _tensor(op.coeffs, device), op.offsets, hermitian=op.hermitian
        )
    if hasattr(op, "a"):
        return MatrixOperator(_tensor(op.a, device))
    if hasattr(op, "d"):
        return DiagonalOperator(_tensor(op.d, device))
    raise TypeError(f"no port of operator type {type(op).__name__}")
