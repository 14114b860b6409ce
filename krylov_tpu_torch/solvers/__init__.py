from .bicgstab import bicgstab
from .cg import cg
from .cg_stencil import cg_stencil
from .gmres import gmres

__all__ = ["bicgstab", "cg", "cg_stencil", "gmres"]
