"""Carry operators across from numpy or from the reference package.

``from_reference`` duck-types the reference package's operators through
``np.asarray`` on their array attributes, so this module imports neither
JAX nor the reference package.  ``np.asarray`` of a JAX array is read-only,
and the port writes some buffers in place, so every array is copied before
it becomes a tensor.
"""

import numpy as np
import torch

from . import _device
from ._operators import ChebyshevPreconditioner, DiagonalOperator, MatrixOperator
from .multigrid import MultigridPreconditioner
from .ops.bsr import BSROperator
from .ops.cuda_spmv import PETOperator
from .ops.sparse import CSROperator, DiaOperator
from .ops.stencil import BandedOperator, ConstStencilOperator, GridStencilOperator


def _tensor(arr, device):
    device = _device.resolve(device)
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


def from_reference(op, device=None, source=None):
    """The port's twin of a reference ``MultigridPreconditioner``,
    ``ConstStencilOperator``, ``GridStencilOperator``, ``BandedOperator``,
    ``CSROperator``, ``DiaOperator``, ``BSROperator``, ``PETOperator``,
    ``MatrixOperator``, ``DiagonalOperator`` or ``ChebyshevPreconditioner``
    (its operator converted, the same interval and degree).  An
    ``SSORSmoother`` holds closures, not arrays: rebuild it from the
    converted operator.

    A multigrid cycle comes across level by level as the reference built
    it: each level's operator, its Jacobi weight (a float on const levels,
    a plane on grid levels) and the coarsest level's dense inverse.  The
    sparse formats come across from their arrays, except ``PETOperator``:
    its page-ELL arrays are the TPU's layout, so the port's is built from
    the scipy matrix ``source`` (or the reference's lazy-adjoint handle to
    it) with the reference's value dtype, adjoint and permutation.
    """
    if hasattr(op, "lmin") and hasattr(op, "degree") and hasattr(op, "A"):
        return ChebyshevPreconditioner(from_reference(op.A, device, source),
                                       (op.lmin, op.lmax), op.degree)
    if hasattr(op, "_pet") and hasattr(op, "ensure_adjoint"):
        sp = source if source is not None else (op._sp() if op._sp is not None else None)
        if sp is None:
            raise TypeError("a reference PETOperator comes across from its scipy "
                            "matrix: pass it as source=")
        perm = None if op._perm is None else np.asarray(op._perm)
        lazy = op._pet_t is None and op._sp is not None
        return PETOperator.from_scipy(
            sp, with_rmatvec="lazy" if lazy else op._pet_t is not None,
            data_dtype=op._data_dtype, reorder=perm, device=device)
    if hasattr(op, "indptr") and hasattr(op, "row_ids"):
        return CSROperator(_tensor(op.data, device), _tensor(op.indices, device),
                           _tensor(op.indptr, device), op.shape,
                           row_ids=_tensor(op.row_ids, device))
    if hasattr(op, "diags") and hasattr(op, "offsets"):
        return DiaOperator(_tensor(op.diags, device), op.offsets, op.shape)
    if hasattr(op, "cols") and hasattr(op, "data"):
        return BSROperator(_tensor(op.data, device), _tensor(op.cols, device), op.shape)
    if hasattr(op, "_vcycle") and hasattr(op, "_nd_shapes"):
        return MultigridPreconditioner.from_parts(
            [from_reference(level, device) for level in op._ops],
            [float(np.asarray(w)) if np.ndim(w) == 0 else _tensor(w, device)
             for w in op._winv],
            None if op._coarse_inv is None else _tensor(op._coarse_inv, device),
            op._nd_shapes, op._r_scale, smooth=op.smooth, omega=op.omega,
            coarse_iters=op.coarse_iters,
        )
    if hasattr(op, "shape_nd") and hasattr(op, "weights"):
        return ConstStencilOperator(op.shape_nd, op.offsets_nd, op.weights,
                                    dtype=np.dtype(op.dtype), device=device)
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
