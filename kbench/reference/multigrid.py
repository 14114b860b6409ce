"""Plain PyTorch geometric V-cycle: a frozen copy of the port's algorithm.

The cycle of ``krylov_tpu_torch.MultigridPreconditioner`` on a constant
stencil, written again without its kernels: each coarse level
rediscretizes the same stencil on the halved grid; damped Jacobi
``z + w (r - A z)`` with ``w = omega / centre`` rounded to the level's
dtype, the first pre-smoothing sweep from zero (``z = w r``); cell-centred
multilinear prolongation with the Dirichlet ghost ``c[-1] = -c[0]`` and its
exact transpose, scaled by ``4 / 2^d``, as restriction; on the coarsest
level a dense inverse where it has at most 4096 points, else
``coarse_iters`` sweeps from zero.  Imports nothing of the port.
"""

import math

import numpy as np
import torch

from .stencil import ConstStencil

DENSE_MAX = 4096


def _can_halve(shape, min_side=4):
    return all(s % 2 == 0 and s // 2 >= min_side for s in shape)


def _prolong_axis(x, ax):
    m = x.shape[ax]
    cm = torch.cat([-x.narrow(ax, 0, 1), x.narrow(ax, 0, m - 1)], dim=ax)
    cp = torch.cat([x.narrow(ax, 1, m - 1), -x.narrow(ax, m - 1, 1)], dim=ax)
    even = 0.75 * x + 0.25 * cm
    odd = 0.75 * x + 0.25 * cp
    y = torch.stack([even, odd], dim=ax + 1)
    return y.reshape(x.shape[:ax] + (2 * m,) + x.shape[ax + 1:])


def _restrict_axis(x, ax):
    m = x.shape[ax] // 2
    xr = x.reshape(x.shape[:ax] + (m, 2) + x.shape[ax + 1:])
    even, odd = xr.select(ax + 1, 0), xr.select(ax + 1, 1)
    zero = torch.zeros_like(even.narrow(ax, 0, 1))
    even_next = torch.cat([even.narrow(ax, 1, m - 1), zero], dim=ax)
    odd_prev = torch.cat([zero, odd.narrow(ax, 0, m - 1)], dim=ax)
    t = 0.75 * (even + odd) + 0.25 * even_next + 0.25 * odd_prev
    first = t.narrow(ax, 0, 1) - 0.25 * even.narrow(ax, 0, 1)
    last = t.narrow(ax, m - 1, 1) - 0.25 * odd.narrow(ax, m - 1, 1)
    return torch.cat([first, t.narrow(ax, 1, m - 2), last], dim=ax)


class VCycle:
    """``z = M @ r``: one V(smooth, smooth) cycle for the stencil ``A``
    (a :class:`ConstStencil`), in ``A.dtype``, on grid-shaped ``r``."""

    def __init__(self, A, smooth=2, omega=0.8, n_levels=None, coarse_iters=40):
        self.smooth, self.coarse_iters = int(smooth), int(coarse_iters)
        shapes = [A.grid]
        while _can_halve(shapes[-1]) and (n_levels is None or len(shapes) < n_levels):
            shapes.append(tuple(s // 2 for s in shapes[-1]))
        self.ops = [A] + [ConstStencil(s, A.offsets, A.weights, A.dtype, A.device)
                          for s in shapes[1:]]
        center = A.center()
        if center == 0.0:
            raise ValueError("the stencil needs a nonzero centre weight")
        self.w = float(torch.tensor(omega / center, dtype=A.dtype))
        self.scale = 4.0 / 2 ** len(A.grid)
        self.coarse_inv = None
        if math.prod(shapes[-1]) <= DENSE_MAX and len(shapes) > 1:
            dense = self.ops[-1].dense().cpu().numpy()
            self.coarse_inv = torch.from_numpy(np.linalg.inv(dense)).to(A.device, A.dtype)

    def _sweeps(self, level, z, r, iters):
        A = self.ops[level]
        for _ in range(iters):
            z = z + self.w * (r - A @ z)
        return z

    def _cycle(self, level, r):
        A, nd = self.ops[level], len(self.ops[level].grid)
        if level == len(self.ops) - 1:
            if self.coarse_inv is not None:
                flat = r.reshape((A.n,) + tuple(r.shape[nd:]))
                return torch.tensordot(self.coarse_inv, flat, dims=1).reshape(r.shape)
            return self._sweeps(level, torch.zeros_like(r), r, self.coarse_iters)
        z = self._sweeps(level, self.w * r, r, self.smooth - 1)
        d = r - A @ z
        for ax in range(nd):
            d = _restrict_axis(d, ax)
        e = self._cycle(level + 1, d * self.scale)
        for ax in range(nd):
            e = _prolong_axis(e, ax)
        return self._sweeps(level, z + e, r, self.smooth)

    def __matmul__(self, r):
        return self._cycle(0, r)
