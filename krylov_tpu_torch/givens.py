"""Givens plane rotations (counterpart of ``krylov_tpu.givens``).

A branch-free, overflow-safe generator with LAPACK ``lartg``'s edge-case
conventions, elementwise over any batch of right-hand-side columns and on
the vectors' device:

* ``g == 0``        -> ``c = 1, s = 0, r = f``
* ``f == 0, g != 0``-> ``c = 0, s = 1`` (real) / ``s = conj(g)/|g|`` (complex)
* otherwise ``c`` real, positive-scaled so that ``|f| > |g|`` gives ``c > 0``.
"""

import torch

from . import _device


def lartg(f, g):
    """Elementwise robust Givens generation.

    Returns ``(c, s, r)`` with ``c`` real such that::

        [  c        s ]   [ f ]   [ r ]
        [ -conj(s)  c ] @ [ g ] = [ 0 ]
    """
    f = _device.as_tensor(f)
    g = _device.as_tensor(g, f.device)
    dtype = torch.promote_types(f.dtype, g.dtype)
    f, g = f.to(dtype), g.to(dtype)

    af, ag = f.abs(), g.abs()
    scale = torch.maximum(af, ag)
    safe_scale = torch.where(scale > 0, scale, 1.0)
    fs, gs = f / safe_scale, g / safe_scale
    d = safe_scale * torch.sqrt(fs.abs() ** 2 + gs.abs() ** 2)
    safe_d = torch.where(d > 0, d, 1.0)

    if dtype.is_complex:
        safe_af = torch.where(af > 0, af, 1.0)
        sgn_f = torch.where(af > 0, f / safe_af, torch.ones_like(f))
        safe_ag = torch.where(ag > 0, ag, 1.0)
        sgn_g = torch.where(ag > 0, g / safe_ag, torch.ones_like(g))
        c_gen = af / safe_d
        s_gen = sgn_f * g.conj() / safe_d
        r_gen = sgn_f * d
        c_f0 = torch.zeros_like(c_gen)
        s_f0 = sgn_g.conj()
        r_f0 = ag.to(dtype)
    else:
        sgn_f = torch.where(f >= 0, 1.0, -1.0).to(dtype)
        c_gen = af / safe_d
        s_gen = sgn_f * g / safe_d
        r_gen = sgn_f * d
        c_f0 = torch.zeros_like(c_gen)
        s_f0 = torch.ones_like(s_gen)
        r_f0 = g

    f_zero, g_zero = af == 0, ag == 0
    c = torch.where(g_zero, 1.0, torch.where(f_zero, c_f0, c_gen))
    s = torch.where(g_zero, torch.zeros_like(s_gen), torch.where(f_zero, s_f0, s_gen))
    r = torch.where(g_zero, f, torch.where(f_zero, r_f0, r_gen))
    return c, s, r


def givens(X):
    """Stacked Givens rotations for a batch of 2-vectors.

    ``X`` has shape ``(2, ...)``; returns ``(G, R)`` with ``G`` of shape
    ``(2, 2, ...)`` and ``G[:, :, idx] @ X[:, idx] = [R[idx], 0]``.
    """
    X = _device.as_tensor(X)
    if X.shape[0] != 2:
        raise ValueError(f"givens takes a (2, ...) stack, got {tuple(X.shape)}")
    c, s, r = lartg(X[0], X[1])
    c = c.to(s.dtype)
    G = torch.stack([torch.stack([c, s]), torch.stack([-s.conj(), c])])
    return G, r


def apply_givens(G, v):
    """``G @ v`` for stacked rotations: ``G.shape == (m, n, ...)``,
    ``v.shape == (n, ...)``."""
    return torch.einsum("ij...,j...->i...", G, v.to(G.dtype))
