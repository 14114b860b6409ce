from .cg import cg
from .cg_stencil import cg_stencil

__all__ = ["cg", "cg_stencil"]
