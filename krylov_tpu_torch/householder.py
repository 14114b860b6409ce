"""Complex-safe Householder reflections (counterpart of
``krylov_tpu.householder``).

Constructs ``H`` with ``H x = alpha * ||x||_2 * e_1``, ``|alpha| = 1``
(Golub & Van Loan, 4th ed., Alg. 5.1.1 with the complex treatment of Sec.
5.1.13), branch-free with ``torch.where`` guards, so nothing is read back
to the host.
"""

import torch

from . import _device
from ._inner import get_default_inner


class Householder:
    def __init__(self, x):
        x = _device.as_tensor(x)
        if not (x.ndim == 1 or (x.ndim == 2 and x.shape[1] == 1)):
            raise ValueError(
                "Householder only works for quasi-1D vectors. "
                f"Input vector has shape {tuple(x.shape)}."
            )
        # Householder requires the Euclidean inner product.
        self.inner = get_default_inner(x.shape)

        v_tail = x[1:]
        gamma = x[0]
        sigma2 = self.inner(v_tail, v_tail)
        sigma2 = sigma2.real if sigma2.is_complex() else sigma2  # exactly real
        abs_gamma = gamma.abs()
        xnorm_full = torch.sqrt(abs_gamma**2 + sigma2)

        is_e1 = sigma2 == 0  # x is a multiple of the first unit vector
        gamma_zero = abs_gamma == 0
        safe_abs_gamma = torch.where(gamma_zero, 1.0, abs_gamma)
        sign_gamma = gamma / safe_abs_gamma

        beta = torch.where(is_e1, 0.0, 2.0).to(sigma2.dtype)
        xnorm = torch.where(is_e1, abs_gamma, xnorm_full)
        one = torch.ones_like(gamma)
        # general case: v0 = gamma + sign(gamma) ||x||  (-sqrt(sigma2) if gamma == 0)
        v0_general = torch.where(
            gamma_zero,
            (-torch.sqrt(sigma2)).to(x.dtype) * one,
            gamma + sign_gamma * xnorm_full,
        )
        v0 = torch.where(is_e1, one, v0_general)
        alpha = torch.where(
            is_e1,
            torch.where(gamma_zero, one,
                        gamma / torch.where(is_e1 & ~gamma_zero, xnorm, 1.0)),
            torch.where(gamma_zero, one, -sign_gamma),
        )
        v = torch.cat([v0.reshape((1,) + tuple(v_tail.shape[1:])), v_tail], dim=0)
        vnorm = torch.sqrt(v0.abs() ** 2 + sigma2)

        self.xnorm = xnorm
        self.v = v / vnorm
        self.alpha = alpha
        self.beta = beta

    def __matmul__(self, x):
        """Apply the reflection: ``x - beta * v * <v, x>``."""
        if x.shape != self.v.shape:
            raise ValueError(
                f"Shape mismatch! (v.shape = {tuple(self.v.shape)} != "
                f"{tuple(x.shape)} = x.shape)"
            )
        return x - self.beta * self.v * self.inner(self.v, x)

    def matrix(self):
        """Dense ``I - beta v v^H`` (for tests)."""
        n = self.v.shape[0]
        eye = torch.eye(n, dtype=self.v.dtype, device=self.v.device)
        eye = eye.reshape((n, n) + (1,) * (self.v.ndim - 1))
        vvH = torch.einsum("i...,j...->ij...", self.v, self.v.conj())
        return eye - self.beta * vvH
