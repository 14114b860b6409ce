"""Operator formats and their kernels (grid-stencil subset)."""

from .stencil import (
    BandedOperator,
    GridStencilOperator,
    diffusion_2d,
    poisson_1d,
    poisson_2d,
    poisson_3d,
)

__all__ = [
    "BandedOperator",
    "GridStencilOperator",
    "diffusion_2d",
    "poisson_1d",
    "poisson_2d",
    "poisson_3d",
]
