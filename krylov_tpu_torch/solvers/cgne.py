"""CGNE — CG on the normal equations ``A A^H y = b``, ``x = A^H y``
(counterpart of ``krylov_tpu.solvers.cgne``)."""

import torch

from .. import _device
from .._info import Info
from .._operators import as_operator
from .cg import cg


class A_AH:
    """Lazy ``A @ A^H`` (two matvecs per application)."""

    def __init__(self, A):
        self.A = A
        self.shape = A.shape
        self.dtype = A.dtype
        self.device = _device.device_of(A)

    def __matmul__(self, x):
        return self.A @ self.A.rmatvec(x)

    matvec = rmatvec = __matmul__  # self-adjoint


def normal_operator(A, b):
    """``A`` as an operator with its adjoint built; a matrix that carries no
    device goes to ``b``'s when ``b`` is a tensor, else to the default
    device."""
    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor) else None)
    if hasattr(A, "ensure_adjoint"):
        A.ensure_adjoint()  # normal-equations solvers need the adjoint
    return A


def cgne(A, b, *args, **kwargs):
    A = normal_operator(A, b)
    sol, info = cg(A_AH(A), b, *args, **kwargs)

    xk = A.rmatvec(info.xk)
    if sol is not None:
        sol = xk
    info = Info(info.success, xk, info.numsteps, info.resnorms,
                info.num_operations, info.arnoldi)
    return sol, info
