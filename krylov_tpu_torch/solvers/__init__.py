from .bicg import bicg
from .bicgstab import bicgstab
from .block import cg_block
from .cg import cg
from .cg_stencil import cg_stencil
from .cgne import cgne
from .cgnr import cgnr
from .cgr import cgr
from .cgs import cgs
from .chebyshev import chebyshev
from .fgmres import fgmres
from .gcr import gcr
from .gmres import gmres
from .lsqr import lsqr
from .minres import minres
from .pipelined import cg_pipelined
from .qmr import qmr
from .refine import refine
from .stationary import SSORSmoother, gauss_seidel, jacobi, richardson, sor, ssor
from .symmlq import symmlq
from .tfqmr import tfqmr

__all__ = [
    "SSORSmoother", "gauss_seidel", "jacobi", "richardson", "sor", "ssor",
    "bicg", "bicgstab", "cg", "cg_block", "cg_pipelined", "cg_stencil", "cgne",
    "cgnr", "cgr", "cgs", "chebyshev", "fgmres", "gcr", "gmres", "lsqr", "minres",
    "qmr", "refine", "symmlq", "tfqmr",
]
