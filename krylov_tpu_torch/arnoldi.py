"""Arnoldi / Lanczos orthogonalization processes (counterpart of
``krylov_tpu.arnoldi``).

Builds V (and P with preconditioning) and H with ``A V_n = V_{n+1} H_n``;
on an A-invariant subspace the relation truncates to ``A V_n = V_n H_n``.
Four variants:

* :class:`ArnoldiMGS` — modified Gram-Schmidt with ``num_reorthos`` passes,
  any inner product and an SPD preconditioner M (dual basis ``V = M P``),
* :class:`ArnoldiCGS` — classical Gram-Schmidt, ``num_passes`` passes,
* :class:`ArnoldiLanczos` — three-term recurrence, O(1) state,
* :class:`ArnoldiHouseholder` — accumulated Householder reflectors,
  Euclidean inner product only.

The numerical content lives in small functional steps (:func:`mgs_sweep`,
:func:`cgs_sweep`, :func:`lanczos_step`, :func:`normalize_dual`,
:func:`padded_reflector_at`), which the ``while_loop`` GMRES uses over its
device buffers; the iterator classes are host-side shells for the eager
interface.  Breakdown: the subdiagonal entry falls to 1e-14 or below, and
iterating past an invariant subspace raises :class:`ArgumentError`.
"""

import numpy as np
import torch

from . import _device
from ._inner import as_inner, get_default_inner
from ._operators import Identity, as_operator
from .errors import ArgumentError
from .householder import Householder

_BREAKDOWN_TOL = 1.0e-14


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def _result_dtype(*objs):
    dts = [_torch_dtype(getattr(o, "dtype", o)) for o in objs]
    out = dts[0]
    for dt in dts[1:]:
        out = torch.promote_types(out, dt)
    return out


def _operator(A, device):
    return as_operator(A, device=device) if isinstance(A, np.ndarray) else A


# ---------------------------------------------------------------------------
# functional steps
# ---------------------------------------------------------------------------


def normalize_dual(inner, M, p, v=None, norm=None):
    """Normalize the dual pair ``(p, v = M p)`` in the M-inner product.

    Returns ``(p_hat, v_hat, norm)``; a zero norm leaves the vectors as
    they are (the caller's breakdown flag handles it).
    """
    if v is None:
        v = M @ p
    if norm is None:
        norm = torch.sqrt(inner(p, v))
    safe = torch.where(norm != 0.0, norm, 1.0)
    return p / safe, v / safe, norm


def mgs_sweep(inner, V, P, w, coeffs):
    """One modified-Gram-Schmidt pass of ``w`` against the bases: subtract
    the ``P`` directions by ``V``-side inner products, adding the
    coefficients into ``coeffs`` (updated in place and returned)."""
    for j, (vj, pj) in enumerate(zip(V, P)):
        c = inner(vj, w)
        coeffs[j] += c
        w = w - c * pj
    return w, coeffs


def cgs_sweep(inner, V, P, w, coeffs):
    """One classical-Gram-Schmidt pass: every coefficient against the same
    incoming ``w``, then one basis combination (``coeffs`` updated in place
    and returned)."""
    cs = [inner(vj, w) for vj in V]
    for j, c in enumerate(cs):
        coeffs[j] += c
    w = w - sum(c * pj for c, pj in zip(cs, P))
    return w, coeffs


def lanczos_step(A, M, inner, v, p, p_old, beta_prev):
    """One three-term Lanczos step: ``(w, Mw, alpha, beta)`` with ``w`` the
    unnormalized next direction ``A v - alpha p - beta_prev p_old`` and
    ``beta`` its M-norm."""
    w = torch.as_tensor(A @ v)
    if p_old is not None:
        w = w - beta_prev * p_old
    alpha = inner(v, w)
    w = w - alpha * p
    Mw = M @ w
    beta = torch.sqrt(inner(w, Mw))
    return w, Mw, alpha, beta


def _padded_reflector(w, k):
    """Householder reflector of ``w[k:]`` stored as a full-length vector
    (zero above ``k``): ``(u, beta, alpha, xnorm)``."""
    house = Householder(w[k:])
    u = torch.zeros_like(w)
    u[k:] = house.v
    return u, house.beta, house.alpha, house.xnorm


def _apply_reflector(u, beta, x):
    return x - beta * u * torch.sum(u.conj() * x, dim=0)


def padded_reflector_at(w, pivot):
    """Householder reflector of ``w[pivot:]`` by masks, for an integer or a
    0-d tensor ``pivot``: the same branch-free construction as
    :class:`~krylov_tpu_torch.householder.Householder`, with trailing
    per-RHS dims.  Entries above the pivot of ``u`` are exactly zero.
    Returns ``(u, beta, alpha, xnorm)`` with ``H w = alpha * xnorm * e_pivot``
    on the suffix.
    """
    w = _device.as_tensor(w)
    n = w.shape[0]
    idx = torch.arange(n, device=w.device).reshape((n,) + (1,) * (w.ndim - 1))
    on_pivot = idx == pivot
    below = idx > pivot

    gamma = torch.sum(torch.where(on_pivot, w, 0), dim=0)  # w[pivot]
    sigma2 = torch.sum(torch.where(below, w.abs() ** 2, 0.0), dim=0)
    abs_gamma = gamma.abs()
    xnorm_full = torch.sqrt(abs_gamma**2 + sigma2)
    is_e1 = sigma2 == 0
    gamma_zero = abs_gamma == 0
    sign_gamma = gamma / torch.where(gamma_zero, 1.0, abs_gamma)

    beta = torch.where(is_e1, 0.0, 2.0).to(sigma2.dtype)
    xnorm = torch.where(is_e1, abs_gamma, xnorm_full)
    one = torch.ones_like(gamma)
    v0 = torch.where(
        is_e1, one,
        torch.where(gamma_zero, (-torch.sqrt(sigma2)).to(w.dtype) * one,
                    gamma + sign_gamma * xnorm_full),
    )
    alpha = torch.where(
        is_e1,
        torch.where(gamma_zero, one,
                    gamma / torch.where(is_e1 & ~gamma_zero, xnorm, 1.0)),
        torch.where(gamma_zero, one, -sign_gamma),
    )
    v = torch.where(on_pivot, v0, torch.where(below, w, 0))
    vnorm = torch.sqrt(v0.abs() ** 2 + sigma2)
    return v / vnorm, beta, alpha, xnorm


# ---------------------------------------------------------------------------
# eager iterator shells
# ---------------------------------------------------------------------------


class _Process:
    """Shared iteration shell: breakdown guard and counter."""

    def __init__(self):
        self.iter = 0
        self.is_invariant = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.is_invariant:
            raise ArgumentError(
                "Krylov subspace was found to be invariant in the previous "
                "iteration."
            )
        out = self._advance()
        self.iter += 1
        return out

    def _flag_breakdown(self, subdiag):
        sub = subdiag.real if subdiag.is_complex() else subdiag
        if bool(torch.all(sub <= _BREAKDOWN_TOL)):
            self.is_invariant = True
            return True
        return False


class _GramSchmidt(_Process):
    """Shared shell of the MGS and CGS processes."""

    def __init__(self, A, v, passes, M, Mv, Mv_norm, inner, sweep):
        super().__init__()
        v = _device.as_tensor(v, _device.device_of(A))
        self.A = _operator(A, v.device)
        self.M = Identity() if M is None else as_operator(M, device=v.device)
        self.inner = as_inner(inner, v.shape)
        self._passes = passes
        self._sweep = sweep
        self.dtype = _result_dtype(self.A, self.M, v)
        # per-RHS scalar shape from the inner itself (a full-contraction
        # inner on grid-shaped vectors gives ())
        self.tail = tuple(self.inner(v, v).shape)
        p0, v0, self.vnorm = normalize_dual(self.inner, self.M, v, v=Mv, norm=Mv_norm)
        self.P = [p0]
        self.V = [v0]

    def _advance(self):
        k = self.iter
        w = torch.as_tensor(self.A @ self.V[k])
        hcol = torch.zeros((k + 2,) + self.tail, dtype=self.dtype, device=w.device)
        for _ in range(self._passes):
            w, hcol = self._sweep(self.inner, self.V, self.P, w, hcol)
        Mw = self.M @ w
        subdiag = torch.sqrt(self.inner(w, Mw))
        hcol[k + 1] = subdiag
        if self._flag_breakdown(subdiag):
            return None, hcol
        p_new, v_new, _ = normalize_dual(self.inner, self.M, w, v=Mw, norm=subdiag)
        self.P.append(p_new)
        self.V.append(v_new)
        return v_new, hcol


class ArnoldiMGS(_GramSchmidt):
    """Arnoldi by (re-orthogonalized) modified Gram-Schmidt; with a
    preconditioner M it keeps the dual bases ``P`` and ``V = M P``."""

    def __init__(self, A, v, num_reorthos=1, M=None, Mv=None, Mv_norm=None,
                 inner=None):
        super().__init__(A, v, num_reorthos, M, Mv, Mv_norm, inner, mgs_sweep)
        self.num_reorthos = num_reorthos


class ArnoldiCGS(_GramSchmidt):
    """Arnoldi by (re-orthogonalized) classical Gram-Schmidt: every sweep is
    one set of inner products against the same vector and one basis
    combination; ``num_passes=2`` (CGS2) is the stable setting."""

    def __init__(self, A, v, num_passes=2, M=None, Mv=None, Mv_norm=None,
                 inner=None):
        super().__init__(A, v, num_passes, M, Mv, Mv_norm, inner, cgs_sweep)
        self.num_passes = num_passes


class ArnoldiLanczos(_Process):
    """Three-term Lanczos recurrence; O(1) state ``(p_old, p, v)``."""

    def __init__(self, A, v, M=None, Mv=None, Mv_norm=None, inner=None):
        super().__init__()
        v = _device.as_tensor(v, _device.device_of(A))
        self.A = _operator(A, v.device)
        self.M = Identity() if M is None else as_operator(M, device=v.device)
        self.inner = as_inner(inner, v.shape)
        self.dtype = _result_dtype(self.A, self.M, v)
        self.tail = tuple(self.inner(v, v).shape)
        self.p_old = None
        self.p, self.v, self.vnorm = normalize_dual(self.inner, self.M, v, v=Mv,
                                                    norm=Mv_norm)
        # current tridiagonal column (upper, diagonal, lower)
        self.h = torch.zeros((3,) + self.tail, dtype=self.dtype, device=v.device)

    @property
    def num_iter(self):
        return self.iter

    def _advance(self):
        beta_prev = self.h[2] if self.iter > 0 else None
        w, Mw, alpha, beta = lanczos_step(
            self.A, self.M, self.inner, self.v, self.p,
            self.p_old if self.iter > 0 else None, beta_prev,
        )
        upper = beta_prev if self.iter > 0 else torch.zeros_like(beta)
        self.h = torch.stack([torch.as_tensor(t).to(self.dtype)
                              for t in (upper, alpha, beta)])
        if self._flag_breakdown(beta):
            self.v = None
            self.p = None
            return self.v, self.h, self.p
        self.p_old = self.p
        self.p, self.v, _ = normalize_dual(self.inner, self.M, w, v=Mw, norm=beta)
        return self.v, self.h, self.p


class ArnoldiHouseholder(_Process):
    """Arnoldi by accumulated full-length Householder reflectors (Euclidean
    inner product only).  Reflector ``j`` is zero above index ``j``, so
    every application is a whole-vector update."""

    def __init__(self, A, v):
        super().__init__()
        self.v = _device.as_tensor(v, _device.device_of(A))
        self.A = _operator(A, self.v.device)
        self.inner = get_default_inner(self.v.shape)
        self.dtype = _result_dtype(self.A, self.v)
        u0, b0, a0, self.vnorm = _padded_reflector(self.v, 0)
        self._reflectors = [(u0, b0, a0)]
        safe = torch.where(self.vnorm != 0.0, self.vnorm, 1.0)
        self.V = [self.v / safe]

    def _project(self, w, upto):
        """Apply reflectors 0..upto, fixing the phase of entry j each step."""
        for j in range(upto + 1):
            u, beta, alpha = self._reflectors[j]
            w = _apply_reflector(u, beta, w)
            w[j] = w[j] * alpha.conj()
        return w

    def _reconstruct(self, k):
        """Basis vector k: the reflectors applied to e_k in reverse order."""
        e = torch.zeros_like(self.v, dtype=self._reflectors[0][0].dtype)
        e[k] = 1
        for u, beta, _ in reversed(self._reflectors):
            e = _apply_reflector(u, beta, e)
        return e * self._reflectors[-1][2]

    def _advance(self):
        k = self.iter
        w = self._project(torch.as_tensor(self.A @ self.V[k]).clone(), k)
        n = self.v.shape[0]
        if k + 1 >= n:
            hcol = torch.zeros((n + 1,) + tuple(self.v.shape[1:]), dtype=w.dtype,
                               device=w.device)
            hcol[:n] = w
            self.is_invariant = True
            return None, hcol
        u, beta, alpha, _ = _padded_reflector(w, k + 1)
        self._reflectors.append((u, beta, alpha))
        w = _apply_reflector(u, beta, w)
        w[k + 1] = w[k + 1] * alpha.conj()
        hcol = w[: k + 2].clone()
        hcol[-1] = w[k + 1].abs()
        if self._flag_breakdown(hcol[-1]):
            return None, hcol
        v_new = self._reconstruct(k + 1)
        self.V.append(v_new)
        return v_new, hcol


def arnoldi_res(A, V, H, inner=None):
    """Arnoldi residual ``|| A V_n - V_{n+1} H_n ||`` (diagnostic)."""
    V = _device.as_tensor(V, _device.device_of(A))
    H = _device.as_tensor(H, V.device).to(V.dtype)
    invariant = H.shape[0] == H.shape[1]
    V1 = V if invariant else V[:, :-1]
    AV = _device.as_tensor(A, V.device) @ V1 if isinstance(A, np.ndarray) else A @ V1
    res = AV - V @ H
    if inner is None:
        inner = get_default_inner(res.shape)
    return torch.sqrt(inner(res, res))
