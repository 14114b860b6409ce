"""Preconditioned conjugate gradient method.

Counterpart of ``krylov_tpu.solvers.cg``: left preconditioner ``Ml``, SPD
preconditioner ``M`` defining the inner-product geometry, arbitrary
``inner``, multi-RHS blocking, per-iteration callback, ``return_arnoldi``
reconstruction of the underlying Lanczos relation and the
``num_operations`` cost model.

The recurrence is a functional ``step`` on a :class:`CGState` driven by
:mod:`krylov_tpu_torch._driver`.  The k==0 search-direction special case is
removed by initializing ``p = 0``; the division guards stay on the device as
``torch.where``, so a step reads nothing back to the host.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Product
from .._steps import put, put2
from ._common import initial_residual, preconditioner, setup


class CGState(NamedTuple):
    yk: torch.Tensor  # solution increment (xk = x0 + yk)
    Ml_rk: torch.Tensor  # left-preconditioned residual
    M_Ml_rk: torch.Tensor  # M-preconditioned residual
    p: torch.Tensor  # search direction
    rho_old: torch.Tensor  # previous <Ml_r, M Ml_r>
    rho: torch.Tensor  # current  <Ml_r, M Ml_r>
    alpha: torch.Tensor  # last step size (for Lanczos reconstruction)
    omega: torch.Tensor  # last direction update coefficient
    resnorm: torch.Tensor


def cg(
    A,
    b,
    M=None,
    Ml=None,
    inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    return_arnoldi: bool = False,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)
    Ml = preconditioner(Ml, b.device)
    Ml_A = Product(Ml, A)

    def residual_and_norm2(z, zero_z=False):
        # zero_z: z is the default all-zero initial guess, so r = b bitwise
        r = initial_residual(A, b, z, zero_z)
        Ml_r = Ml @ r
        M_Ml_r = M @ Ml_r
        norm2 = ensure_real(inner(Ml_r, M_Ml_r), "<x, M x>")
        return M_Ml_r, Ml_r, norm2

    M_Ml_r0, Ml_r0, norm2_0 = residual_and_norm2(x0, zero_z=x0_default)
    resnorm0 = torch.sqrt(norm2_0)

    if callback is not None:
        callback(x0, Ml_r0)

    state0 = CGState(
        yk=torch.zeros(x0.shape, dtype=M_Ml_r0.dtype, device=b.device),
        Ml_rk=Ml_r0,
        M_Ml_rk=M_Ml_r0,
        p=torch.zeros_like(M_Ml_r0),
        rho_old=torch.ones_like(norm2_0),
        rho=norm2_0,
        # alpha = rho / <p, Ap> inherits the (possibly complex) vector dtype
        alpha=torch.zeros(
            norm2_0.shape,
            dtype=torch.promote_types(norm2_0.dtype, M_Ml_r0.dtype),
            device=b.device,
        ),
        omega=torch.zeros_like(norm2_0),
        resnorm=resnorm0,
    )

    def step(s: CGState, criterion, ctl) -> CGState:
        omega = s.rho / torch.where(s.rho_old != 0, s.rho_old, 1.0)
        p = s.M_Ml_rk + omega * s.p  # exact for k==0 since p0 == 0
        Ap = Ml_A @ p
        pAp = inner(p, Ap)
        alpha = s.rho / torch.where(pAp != 0, pAp, 1.0)
        yk = s.yk + alpha * p
        Ml_rk = s.Ml_rk - alpha * Ap
        M_Ml_rk = M @ Ml_rk
        rho_new = ensure_real(inner(Ml_rk, M_Ml_rk), "<r, M r>")
        return CGState(
            yk=yk,
            Ml_rk=Ml_rk,
            M_Ml_rk=M_Ml_rk,
            p=p,
            rho_old=s.rho,
            rho=rho_new,
            alpha=alpha,
            omega=omega,
            resnorm=torch.sqrt(rho_new),
        )

    def xk_of(s: CGState):
        return x0 + s.yk

    def explicit_resnorm(xk):
        return torch.sqrt(residual_and_norm2(xk)[2])

    # the device Arnoldi wrapper writes its buffers at the step's number
    if return_arnoldi and backend != EAGER:
        step = _arnoldi_on_device(step, state0, b.shape, maxiter)

    # optional Lanczos-relation reconstruction (eager: host-side bookkeeping)
    on_step = None
    arnoldi_acc = None
    if return_arnoldi and backend == EAGER:
        safe0 = torch.where(resnorm0 > 0.0, resnorm0, 1.0)
        arnoldi_acc = {
            "V": [M_Ml_r0 / safe0],
            "P": [Ml_r0 / safe0],
            "H": np.zeros([maxiter + 1, maxiter] + list(b.shape[1:]), dtype=float),
            "k": 0,
            "alpha_old": 0.0,
        }

        def on_step(old: CGState, new: CGState):
            acc = arnoldi_acc
            k = acc["k"]
            sign = (-1) ** (k + 1)
            acc["V"].append(sign * new.M_Ml_rk / new.resnorm)
            acc["P"].append(sign * new.Ml_rk / new.resnorm)
            H = acc["H"]
            H[k, k] = _host(1.0 / new.alpha)
            if k > 0:
                H[k - 1, k] = H[k, k - 1]
                H[k, k] += _host(new.omega / acc["alpha_old"])
            H[k + 1, k] = _host(torch.sqrt(new.rho / new.rho_old) / new.alpha)
            acc["alpha_old"] = new.alpha
            acc["k"] = k + 1

    method = Method(
        step=step,
        xk=lambda s, k: xk_of(s),
        explicit_resnorm=explicit_resnorm,
        callback_args=lambda s, k: (xk_of(s), s.Ml_rk),
        on_step=on_step,
        capturable=True,
        counted=True,
    )

    state, success, k, resnorms = run(
        state0,
        method,
        tol=tol,
        atol=atol,
        maxiter=maxiter,
        callback=callback,
        backend=backend,
    )

    xk = xk_of(state)
    num_operations = {
        "A": 1 + k,
        "M": 2 + k,
        "Ml": 2 + k,
        "Mr": 1 + k,
        "inner": 2 + 2 * k,
        "axpy": 2 + 2 * k,
    }

    arnoldi = None
    if return_arnoldi and backend == EAGER:
        H = arnoldi_acc["H"][: arnoldi_acc["k"] + 1, : arnoldi_acc["k"]]
        arnoldi = [arnoldi_acc["V"], H, arnoldi_acc["P"]]
    elif return_arnoldi:
        Vb, Hb, Pb = step.buffers
        # the superdiagonal mirrors the subdiagonal: H[i - 1, i] = H[i, i - 1]
        i = torch.arange(1, k, device=Hb.device)
        Hb[i - 1, i] = Hb[i, i - 1]
        arnoldi = [list(Vb[: k + 1]), Hb[: k + 1, :k].cpu().numpy(), list(Pb[: k + 1])]

    info = Info(success, xk, k, resnorms, num_operations, arnoldi)
    return (xk if success else None), info


def _arnoldi_on_device(step, state0, b_shape, maxiter):
    """``step`` wrapped to record the Lanczos relation on the device, as
    the reference's compiled backend does: the V and P bases in fixed
    ``(maxiter + 1, *b.shape)`` buffers, the tridiagonal H in a
    ``(maxiter + 1, maxiter, *b.shape[1:])`` buffer, each written from
    device scalars at the step's number (:mod:`.._steps`: the host's count,
    or the device counter of the graph route), so nothing is read back.
    The superdiagonal is left to the caller, a mirror of the subdiagonal.
    The buffers are the wrapper's ``buffers`` attribute."""
    vdt = state0.M_Ml_rk.dtype
    dev = state0.M_Ml_rk.device
    safe0 = torch.where(state0.resnorm > 0.0, state0.resnorm, 1.0)
    Vb = torch.zeros((maxiter + 1,) + tuple(b_shape), dtype=vdt, device=dev)
    Pb = torch.zeros_like(Vb)
    Vb[0] = state0.M_Ml_rk / safe0
    Pb[0] = state0.Ml_rk / safe0
    Hb = torch.zeros((maxiter + 1, maxiter) + tuple(b_shape[1:]),
                     dtype=torch.promote_types(state0.rho.dtype, vdt), device=dev)

    def arn_step(s: CGState, criterion, ctl) -> CGState:
        k = ctl.k
        ns = step(s, criterion, ctl)

        def signed(v):  # (-1)^(k + 1) v
            return ctl.pick(k % 2 == 1, lambda: v, lambda: -v)

        put(Vb, k + 1, signed(ns.M_Ml_rk / ns.resnorm))
        put(Pb, k + 1, signed(ns.Ml_rk / ns.resnorm))
        # s.alpha: the step size of the step before
        inv_alpha = 1.0 / ns.alpha
        put2(Hb, k, k, ctl.pick(k == 0, lambda: inv_alpha,
                                lambda: inv_alpha + ns.omega / s.alpha))
        put2(Hb, k + 1, k, torch.sqrt(ns.rho / ns.rho_old) / ns.alpha)
        return ns

    arn_step.buffers = (Vb, Hb, Pb)
    return arn_step


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t
