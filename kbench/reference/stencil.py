"""Plain PyTorch product of a constant-coefficient stencil.

``y[i] = sum_d w_d * x[i + o_d]`` on an n-D grid with zero (Dirichlet)
values outside it: the operator that the port's ``ConstStencilOperator``
applies through its K2 kernel, written again from its definition.  Vectors
are grid-shaped, ``(*grid)`` or ``(*grid, *tail)``; trailing axes are
independent right-hand sides.  Imports nothing of the port.
"""

import torch


class ConstStencil:
    """The stencil ``offsets``/``weights`` on ``grid``, computed in ``dtype``."""

    def __init__(self, grid, offsets, weights, dtype, device):
        self.grid = tuple(int(s) for s in grid)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.weights = tuple(float(w) for w in weights)
        self.dtype = dtype
        self.device = torch.device(device)
        if any(len(off) != len(self.grid) for off in self.offsets):
            raise ValueError("every offset needs one step per grid axis")
        # neighbours in ascending offset order, the centre among them
        self.bands = sorted(zip(self.offsets, self.weights))

    @property
    def n(self):
        return int(torch.tensor(self.grid).prod())

    def center(self):
        return sum(w for off, w in self.bands if not any(off))

    def __matmul__(self, x):
        nd = len(self.grid)
        if tuple(x.shape[:nd]) != self.grid:
            raise ValueError(f"x of shape {tuple(x.shape)} is not on the grid {self.grid}")
        y = torch.zeros_like(x)
        for off, w in self.bands:
            dst, src = [], []
            for o, m in zip(off, self.grid):
                lo, hi = max(0, -o), m - max(0, o)
                if hi <= lo:
                    break
                dst.append(slice(lo, hi))
                src.append(slice(lo + o, hi + o))
            else:
                y[tuple(dst)].add_(x[tuple(src)], alpha=w)
        return y

    def dense(self):
        """The operator as a dense ``(n, n)`` float64 matrix (small grids)."""
        n = self.n
        eye = torch.eye(n, dtype=torch.float64, device=self.device)
        cols = ConstStencil(self.grid, self.offsets, self.weights, torch.float64,
                            self.device) @ eye.reshape(self.grid + (n,))
        return cols.reshape(n, n)

