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
from ._operators import (
    ChebyshevPreconditioner,
    DiagonalOperator,
    Identity,
    MatrixOperator,
    Product,
)
from .amg import AMGPreconditioner
from .blockjacobi import BlockJacobiPreconditioner
from .ilu import ILUPreconditioner
from .multigrid import MultigridPreconditioner
from .ops.bsr import BSROperator
from .ops.cuda_spmv import PETOperator
from .ops.sparse import CSROperator, DiaOperator
from .ops.stencil import BandedOperator, ConstStencilOperator, GridStencilOperator
from .ops.triangular import StackedTriangularSweep


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


def _optional(arr, device):
    return None if arr is None else _tensor(arr, device)


def _perm(arr, device):
    return None if arr is None else _tensor(arr, device).long()


def _sweep_from_reference(sw, device):
    return StackedTriangularSweep(*(_tensor(a, device) for a in (
        sw.rows, sw.diag, sw.dat, sw.col, sw.lrow)), sw.n_local)


def from_reference(op, device=None, source=None):
    """The port's twin of a reference ``MultigridPreconditioner``,
    ``AMGPreconditioner``, ``ILUPreconditioner``,
    ``BlockJacobiPreconditioner``, ``ConstStencilOperator``,
    ``GridStencilOperator``, ``BandedOperator``, ``CSROperator``,
    ``DiaOperator``, ``BSROperator``, ``PETOperator``, ``MatrixOperator``,
    ``DiagonalOperator``, ``ChebyshevPreconditioner`` (its operator
    converted, the same interval and degree), ``Product`` (each factor
    converted) or ``Identity``.  An ``SSORSmoother`` holds
    closures, not arrays: rebuild it from the converted operator.

    An AMG hierarchy comes across level by level (each level operator and
    tentative prolongator through these same branches, the Jacobi vectors,
    the coarse inverse or the coarse fallback, the ``lmax`` estimates, the
    prolongator weights and the smoother); ILU as its two level-scheduled
    sweeps, permutations and adjoint; block Jacobi as its inverses.

    A multigrid cycle comes across level by level as the reference built
    it: each level's operator, its Jacobi weight (a float on const levels,
    a plane on grid levels) and the coarsest level's dense inverse.  The
    sparse formats come across from their arrays, except ``PETOperator``:
    its page-ELL arrays are the TPU's layout, so the port's is built from
    the scipy matrix ``source`` (or the reference's lazy-adjoint handle to
    it) with the reference's value dtype, adjoint and permutation.
    """
    if type(op).__name__ == "Identity":
        return Identity()
    if hasattr(op, "operators"):
        return Product(*(from_reference(o, device, source) for o in op.operators))
    if hasattr(op, "_phats") and hasattr(op, "_dinvs"):
        return AMGPreconditioner(
            [from_reference(level, device) for level in op._ops],
            [from_reference(p, device) for p in op._phats],
            [_tensor(d, device) for d in op._dinvs], _optional(op._coarse_inv, device),
            op.smooth, op.omega, smoother=op.smoother, lmaxs=op._lmaxs,
            coarse_op=None if op._coarse_op is None else from_reference(op._coarse_op, device),
            coarse_dinv=_optional(op._coarse_dinv, device), p_w=op._p_w)
    if hasattr(op, "_l") and hasattr(op, "_u") and hasattr(op, "_adj"):
        adj = None if op._adj is None else (
            _sweep_from_reference(op._adj[0], device), _sweep_from_reference(op._adj[1], device),
            _perm(op._adj[2], device), _perm(op._adj[3], device))
        return ILUPreconditioner(_sweep_from_reference(op._l, device),
                                 _sweep_from_reference(op._u, device),
                                 _perm(op._ipr, device), _perm(op._pc, device), adj=adj)
    if hasattr(op, "_inv") and hasattr(op, "block"):
        return BlockJacobiPreconditioner(_tensor(op._inv, device), op.shape[0])
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
