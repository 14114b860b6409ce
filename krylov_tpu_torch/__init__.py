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
the constant-coefficient stencil operator with its fused CG, and the
geometric multigrid preconditioner (:class:`MultigridPreconditioner`).
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
from .errors import ArgumentError
from .multigrid import MultigridPreconditioner
from .ops.stencil import poisson_2d_const, poisson_3d_const
from .solvers import cg, cg_stencil

__all__ = [
    "ArgumentError",
    "DiagonalOperator",
    "Identity",
    "Info",
    "MatrixOperator",
    "MultigridPreconditioner",
    "Product",
    "as_operator",
    "cg",
    "cg_stencil",
    "convert",
    "jacobi_preconditioner",
    "ops",
    "poisson_2d_const",
    "poisson_3d_const",
]
