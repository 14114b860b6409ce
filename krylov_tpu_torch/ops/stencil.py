"""Row-wise banded (stencil) operators and grid-Laplacian generators.

Counterpart of ``krylov_tpu.ops.stencil`` (banded and grid-stencil subset).
Row-wise banded storage ``coeffs[d, i] = A[i, i + offsets[d]]`` makes the
matvec a sum of shifted elementwise products with no index traffic.  The
grid form (:class:`GridStencilOperator`) runs its matvec through the
hand-written CUDA stencil kernel on a CUDA device and through the kernel's
plain PyTorch version on the CPU (:mod:`krylov_tpu_torch.ops.cuda_stencil`).

The constructors build their coefficients with numpy exactly as the
reference package does, then place them on ``device``.
"""

import numpy as np
import torch

from . import cuda_stencil


class BandedOperator:
    """Row-wise banded operator: ``y[i] = sum_d coeffs[d, i] * x[i + offsets[d]]``.

    ``coeffs`` has shape ``(ndiag, N)``; entries whose column index would fall
    outside [0, N) must be zero (enforced by the constructors here).
    """

    def __init__(self, coeffs, offsets, hermitian=False):
        self.coeffs = coeffs
        self.offsets = tuple(int(o) for o in offsets)
        self.hermitian = bool(hermitian)

    @property
    def shape(self):
        n = self.coeffs.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @property
    def nnz(self):
        n = self.coeffs.shape[1]
        return sum(n - abs(o) for o in self.offsets)

    def _banded(self, x, conj):
        n = self.coeffs.shape[1]
        cf = self.coeffs.conj() if conj else self.coeffs
        y = torch.zeros(
            x.shape, dtype=torch.promote_types(cf.dtype, x.dtype), device=x.device
        )
        tail = (1,) * (x.ndim - 1)
        for d, off in enumerate(self.offsets):
            # forward: y[i] += c[i] x[i + off]; adjoint: y[i + off] += c[i] x[i]
            if off >= 0:
                c = cf[d, : n - off].reshape((n - off,) + tail)
                if conj:
                    y[off:] += c * x[: n - off]
                else:
                    y[: n - off] += c * x[off:]
            else:
                c = cf[d, -off:].reshape((n + off,) + tail)
                if conj:
                    y[: n + off] += c * x[-off:]
                else:
                    y[-off:] += c * x[: n + off]
        return y

    def __matmul__(self, x):
        return self._banded(x, conj=False)

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        return self._banded(x, conj=True)

    def diagonal(self):
        if 0 in self.offsets:
            return self.coeffs[self.offsets.index(0)]
        return torch.zeros(self.coeffs.shape[1], dtype=self.dtype, device=self.device)


class GridStencilOperator(BandedOperator):
    """Banded operator whose bands decompose over a grid with last dim ``ny``.

    Same flat ``(N,)``-vector interface and semantics as
    :class:`BandedOperator`, plus a grid factorization ``offset = dr * ny +
    dc`` (``|dc| < ny/2``): the matvec runs as a 2-D stencil on the
    ``(M, ny)`` grid view.

    Contract: coefficients must be zero wherever the 2-D neighbor
    ``(i + dr, j + dc)`` leaves the grid (the constructors here guarantee
    it); the kernel reads such neighbors as zeros.

    Coefficients are stored as ``(ndiag, M, ny)``; the flat ``(ndiag, N)``
    view used by the inherited methods is exposed as a property.  Vectors
    may be flat ``(N,)``, grid-shaped ``(M, ny)`` (the fast path for whole
    solves, with a full-contraction ``inner``), multi-RHS ``(N, k)`` or
    grid-shaped multi-RHS ``(M, ny, k)``.
    """

    def __init__(self, coeffs, offsets, ny, hermitian=False):
        self.offsets = tuple(int(o) for o in offsets)
        self.hermitian = bool(hermitian)
        self.ny = int(ny)
        if coeffs.ndim == 2:
            n = coeffs.shape[1]
            if n % self.ny:
                raise ValueError(f"N={n} not a multiple of grid last-dim {ny}")
            coeffs = coeffs.reshape(coeffs.shape[0], n // self.ny, self.ny)
        self.coeffs2d = coeffs.contiguous()  # (ndiag, M, ny)
        self.row_offsets = tuple(int(round(o / self.ny)) for o in self.offsets)
        self.col_offsets = tuple(
            int(o - r * self.ny) for o, r in zip(self.offsets, self.row_offsets)
        )
        if any(abs(c) >= self.ny for c in self.col_offsets):
            raise ValueError(f"offsets {self.offsets} do not decompose over ny={ny}")
        self.halo = cuda_stencil.halo_rows(self.row_offsets)

    @property
    def coeffs(self):
        """Flat row-aligned view (ndiag, N) — utility paths only."""
        nd, M, ny = self.coeffs2d.shape
        return self.coeffs2d.reshape(nd, M * ny)

    @property
    def grid(self):
        """(M, ny) collapsed grid shape of this operator's vector space."""
        return tuple(self.coeffs2d.shape[1:])

    # solvers accept grid-shaped vectors for this operator (solvers/_common.py)
    vector_shape = grid

    def _apply_grid(self, x, top_halo=None, bot_halo=None):
        """Matvec on the ``(M, ny)`` grid view, or a ``(B, M, ny)`` batch.

        Callers may pass ``(h_caller, ny)`` halos with ``h_caller >= h``:
        the rows next to the grid are kept.
        """
        h = self.halo
        trim_t = None if top_halo is None or h == 0 else top_halo[-h:]
        trim_b = None if bot_halo is None or h == 0 else bot_halo[:h]
        return cuda_stencil.stencil2d_matvec(
            self.coeffs2d, x.contiguous(), self.row_offsets, self.col_offsets,
            top_halo=trim_t, bot_halo=trim_b,
        )

    def __matmul__(self, x):
        M, ny = self.grid
        if x.ndim == 2 and tuple(x.shape) == (M, ny):
            return self._apply_grid(x)  # grid-shaped vector
        if x.ndim == 2:
            # multi-RHS (N, k): the kernel's batch dimension runs the columns
            k = x.shape[1]
            yb = self._apply_grid(x.T.reshape(k, M, ny))
            return yb.reshape(k, M * ny).T
        if x.ndim == 3 and tuple(x.shape[:2]) == (M, ny):
            # grid-shaped blocked RHS (M, ny, k)
            return self._apply_grid(x.permute(2, 0, 1)).permute(1, 2, 0)
        if x.ndim != 1:
            return BandedOperator.__matmul__(self, x)
        return self._apply_grid(x.reshape(M, ny)).reshape(x.shape)

    matvec = __matmul__


def _as_device_tensor(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _laplacian_coeffs(shape_nd, dtype):
    """Row-wise banded coefficients of the (2*d)-point Laplacian on an
    n-D grid with natural (last-axis-fastest) ordering and Dirichlet BCs."""
    nd = len(shape_nd)
    N = int(np.prod(shape_nd))
    idx = np.arange(N)
    coords = np.stack(np.unravel_index(idx, shape_nd), axis=0)  # (nd, N)

    strides = [int(np.prod(shape_nd[k + 1 :])) for k in range(nd)]
    offsets = [0]
    coeff_rows = [np.full(N, 2.0 * nd, dtype=dtype)]
    for k in range(nd):
        s = strides[k]
        # +s neighbor exists when coord < n_k - 1
        mask_p = (coords[k] < shape_nd[k] - 1).astype(dtype)
        mask_m = (coords[k] > 0).astype(dtype)
        offsets.append(s)
        coeff_rows.append(-mask_p)
        offsets.append(-s)
        coeff_rows.append(-mask_m)

    order = np.argsort(offsets)
    offsets = [offsets[i] for i in order]
    coeffs = np.stack([coeff_rows[i] for i in order], axis=0)
    return coeffs, offsets


def poisson_1d(n, dtype=np.float64, device=None):
    """Tridiagonal 1-D Laplacian (Dirichlet)."""
    coeffs, offsets = _laplacian_coeffs((n,), np.dtype(dtype))
    return BandedOperator(_as_device_tensor(coeffs, device), offsets, hermitian=True)


def poisson_2d(nx, ny=None, dtype=np.float64, device=None):
    """5-point 2-D Laplacian (Dirichlet) on an (nx, ny) grid."""
    ny = nx if ny is None else ny
    coeffs, offsets = _laplacian_coeffs((nx, ny), np.dtype(dtype))
    return GridStencilOperator(
        _as_device_tensor(coeffs, device), offsets, ny, hermitian=True
    )


def diffusion_2d(a, dtype=None, device=None):
    """SPD 5-point FV discretization of ``-div(a grad u)`` with Dirichlet
    walls on the grid of cell coefficients ``a`` (shape ``(nx, ny)``).

    Face conductivities are arithmetic means of the adjacent cells;
    boundary faces use the boundary cell's own coefficient, so the center
    includes the wall links and the matrix is positive definite.
    ``a = ones`` reproduces ``poisson_2d``.
    """
    a = np.asarray(a, dtype=dtype)
    nx, ny = a.shape
    axf = np.zeros((nx + 1, ny), a.dtype)
    axf[1:nx] = 0.5 * (a[1:, :] + a[:-1, :])
    axf[0], axf[nx] = a[0, :], a[-1, :]
    ayf = np.zeros((nx, ny + 1), a.dtype)
    ayf[:, 1:ny] = 0.5 * (a[:, 1:] + a[:, :-1])
    ayf[:, 0], ayf[:, ny] = a[:, 0], a[:, -1]
    c = np.zeros((5, nx, ny), a.dtype)
    c[0, 1:, :] = -axf[1:nx]
    c[4, :-1, :] = -axf[1:nx]
    c[1, :, 1:] = -ayf[:, 1:ny]
    c[3, :, :-1] = -ayf[:, 1:ny]
    c[2] = axf[:-1] + axf[1:] + ayf[:, :-1] + ayf[:, 1:]
    return GridStencilOperator(
        _as_device_tensor(c, device), (-ny, -1, 0, 1, ny), ny, hermitian=True
    )


def poisson_3d(nx, ny=None, nz=None, dtype=np.float64, device=None):
    """7-point 3-D Laplacian (Dirichlet) on an (nx, ny, nz) grid.

    Grid-collapsed to 2-D ``(nx * ny, nz)``: offsets ±1 are column shifts,
    ±nz and ±ny*nz are row shifts.
    """
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    coeffs, offsets = _laplacian_coeffs((nx, ny, nz), np.dtype(dtype))
    return GridStencilOperator(
        _as_device_tensor(coeffs, device), offsets, nz, hermitian=True
    )
