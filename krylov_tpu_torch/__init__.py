"""krylov_tpu_torch — the PyTorch and CUDA port of krylov_tpu.

Same solver contract as ``krylov_tpu`` (the reference package, which this
package never imports): every solver is a functional recurrence driven by
one loop in two backends, ``eager`` (host loop, the float64 parity mode on
CPU) and ``while_loop`` (state and residual history resident on the
device, one stop-flag read per step).  Operators hold their tensors on an
explicit device.  The grid-stencil kernels are hand-written CUDA for Hopper
(``krylov_tpu_torch/csrc``), built with ``nvcc`` at first use; on CPU
tensors the same entry points run the kernels' plain PyTorch versions.

Ported so far: compiled CG on grid stencils (:func:`cg`, :func:`cg_stencil`,
the banded and grid-stencil operators, the L0 operator and driver layer),
the constant-coefficient stencil operator with its fused CG, the geometric
multigrid preconditioner (:class:`MultigridPreconditioner`), and general
sparsity: scipy matrices through :func:`as_operator` (CSR, BSR and the CSR
kernels), :func:`bicgstab`, :func:`gmres` and the Arnoldi processes.
"""

from . import convert, ops
from ._info import Info
from ._operators import (
    DiagonalOperator,
    Identity,
    MatrixOperator,
    Product,
    as_operator,
    jacobi_preconditioner,
)
from .arnoldi import (
    ArnoldiCGS,
    ArnoldiHouseholder,
    ArnoldiLanczos,
    ArnoldiMGS,
    arnoldi_res,
)
from .errors import ArgumentError
from .givens import givens
from .householder import Householder
from .multigrid import MultigridPreconditioner
from .ops.stencil import poisson_2d_const, poisson_3d_const
from .solvers import bicgstab, cg, cg_stencil, gmres

aslinearoperator = as_operator  # the reference's alias

__all__ = [
    "ArgumentError",
    "ArnoldiCGS",
    "ArnoldiHouseholder",
    "ArnoldiLanczos",
    "ArnoldiMGS",
    "DiagonalOperator",
    "Householder",
    "Identity",
    "Info",
    "MatrixOperator",
    "MultigridPreconditioner",
    "Product",
    "arnoldi_res",
    "as_operator",
    "aslinearoperator",
    "bicgstab",
    "cg",
    "cg_stencil",
    "convert",
    "givens",
    "gmres",
    "jacobi_preconditioner",
    "ops",
    "poisson_2d_const",
    "poisson_3d_const",
]
