"""CGNR — CG on the normal equations ``A^H A x = A^H b`` (counterpart of
``krylov_tpu.solvers.cgnr``)."""

from .. import _device
from .cg import cg
from .cgne import normal_operator


class AH_A:
    """Lazy ``A^H @ A`` (two matvecs per application)."""

    def __init__(self, A):
        self.A = A
        self.shape = A.shape
        self.dtype = A.dtype
        self.device = _device.device_of(A)

    def __matmul__(self, x):
        return self.A.rmatvec(self.A @ x)

    matvec = rmatvec = __matmul__  # self-adjoint


def cgnr(A, b, *args, **kwargs):
    A = normal_operator(A, b)
    b = _device.as_tensor(b, _device.device_of(A))
    return cg(AH_A(A), A.rmatvec(b), *args, **kwargs)
