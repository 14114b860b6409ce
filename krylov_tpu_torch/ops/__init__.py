"""Operator formats and their kernels (stencil subset)."""

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
