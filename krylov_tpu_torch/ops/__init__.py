"""Operator formats and their kernels: stencils, CSR (portable and on the
CSR kernels) and BSR."""

from .bsr import BSROperator
from .cuda_spmv import PETOperator
from .sparse import CSROperator, DiaOperator
from .stencil import (
    BandedOperator,
    ConstStencilOperator,
    GridStencilOperator,
    diffusion_2d,
    poisson_1d,
    poisson_2d,
    poisson_2d_const,
    poisson_3d,
    poisson_3d_const,
)

__all__ = [
    "BSROperator",
    "CSROperator",
    "DiaOperator",
    "PETOperator",
    "BandedOperator",
    "ConstStencilOperator",
    "GridStencilOperator",
    "diffusion_2d",
    "poisson_1d",
    "poisson_2d",
    "poisson_2d_const",
    "poisson_3d",
    "poisson_3d_const",
]
