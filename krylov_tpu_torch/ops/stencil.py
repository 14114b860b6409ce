"""Row-wise banded (stencil) operators and grid-Laplacian generators.

Counterpart of ``krylov_tpu.ops.stencil`` (banded and grid-stencil subset).
Row-wise banded storage ``coeffs[d, i] = A[i, i + offsets[d]]`` makes the
matvec a sum of shifted elementwise products with no index traffic.  The
grid form (:class:`GridStencilOperator`) runs its matvec through the
hand-written CUDA stencil kernel on a CUDA device and through the kernel's
plain PyTorch version on the CPU (:mod:`krylov_tpu_torch.ops.cuda_stencil`).

The constructors build their coefficients with numpy exactly as the
reference package does, then place them on ``device`` (the package's default device when None).
"""

import numpy as np
import torch

from .. import _device
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

    def toscipy(self):
        """Host-side scipy CSR twin (set-up and analysis paths only)."""
        import scipy.sparse

        n = self.coeffs.shape[1]
        cf = self.coeffs.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(cf[d, i])
        return scipy.sparse.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n),
        )

    def tocsr(self):
        from .sparse import CSROperator

        return CSROperator.from_scipy(self.toscipy(), device=self.device)

    def todense(self):
        n = self.coeffs.shape[1]
        out = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for d, off in enumerate(self.offsets):
            i = torch.arange(max(0, -off), min(n, n - off), device=self.device)
            out[i, i + off] = self.coeffs[d, i]
        return out

    def tree_flatten(self):
        return (self.coeffs,), (self.offsets, self.hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, hermitian = aux
        return cls(children[0], offsets, hermitian=hermitian)


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

    ``row_col_offsets=(row_offsets, col_offsets)`` gives each band's 2-D
    offset directly, with ``offsets=None``: on narrow grids two 2-D offsets
    can share one flat offset (at ``ny = 4``, ``(-1, +2)`` and ``(0, -2)``
    are both ``-2``), and the decomposition of flat offsets would merge
    them.
    """

    def __init__(self, coeffs, offsets, ny, hermitian=False, row_col_offsets=None):
        self.hermitian = bool(hermitian)
        self.ny = int(ny)
        if coeffs.ndim == 2:
            n = coeffs.shape[1]
            if n % self.ny:
                raise ValueError(f"N={n} not a multiple of grid last-dim {ny}")
            coeffs = coeffs.reshape(coeffs.shape[0], n // self.ny, self.ny)
        self.coeffs2d = coeffs.contiguous()  # (ndiag, M, ny)
        if row_col_offsets is None:
            self.offsets = tuple(int(o) for o in offsets)
            self.row_offsets = tuple(int(round(o / self.ny)) for o in self.offsets)
            self.col_offsets = tuple(
                int(o - r * self.ny) for o, r in zip(self.offsets, self.row_offsets)
            )
        else:
            self.row_offsets, self.col_offsets = (
                tuple(int(o) for o in offs) for offs in row_col_offsets
            )
            self.offsets = tuple(
                r * self.ny + c for r, c in zip(self.row_offsets, self.col_offsets)
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

    def tree_flatten(self):
        return (self.coeffs2d,), (self.ny, self.hermitian,
                                  (self.row_offsets, self.col_offsets))

    @classmethod
    def tree_unflatten(cls, aux, children):
        ny, hermitian, row_col_offsets = aux
        return cls(children[0], None, ny, hermitian=hermitian,
                   row_col_offsets=row_col_offsets)


def _as_device_tensor(arr, device):
    """``arr`` on ``device``, the default device when None."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(_device.resolve(device))


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


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class ConstStencilOperator:
    """Constant-coefficient n-D stencil with Dirichlet boundaries.

    The operator carries only scalar weights, no coefficient arrays, so a
    matvec moves ``x`` and ``y`` alone (about 2N words).  Boundary masks
    are computed in the kernel (K2, :func:`cuda_stencil.const_stencil2d_matvec`)
    from the per-band row constraints and column bounds.

    ``shape_nd`` is the n-D grid shape (n >= 2); ``offsets_nd`` a tuple of
    n-D integer offset vectors and ``weights`` the matching scalars.  The
    grid collapses to ``(M, ny) = (prod(shape[:-1]), shape[-1])``; vectors
    may be flat ``(N,)``, grid-shaped ``(M, ny)``, multi-RHS ``(N, k)`` or
    grid-shaped multi-RHS ``(M, ny, k)``.  ``dtype`` is a ``torch.dtype``
    (numpy dtypes are converted).  The operator holds no tensors and
    computes on the vector's device; ``device`` (the default device when
    None) is where tensors derived from it (``diagonal()``, a multigrid
    hierarchy's coarse inverse) and right-hand sides that carry no device
    go.
    """

    def __init__(self, shape_nd, offsets_nd, weights, dtype=np.float64, device=None):
        self.shape_nd = tuple(int(s) for s in shape_nd)
        if len(self.shape_nd) < 2:
            raise ValueError("use BandedOperator for 1-D stencils")
        self.offsets_nd = tuple(tuple(int(o) for o in off) for off in offsets_nd)
        self.weights = tuple(float(w) for w in weights)
        self.dtype = _torch_dtype(dtype)
        self.device = _device.resolve(device)
        self.ny = self.shape_nd[-1]
        row_axes = self.shape_nd[:-1]
        self._M = int(np.prod(row_axes))
        # collapse: row strides (in rows) of each leading axis
        strides = [int(np.prod(row_axes[k + 1 :])) for k in range(len(row_axes))]

        bands = []
        for off, w in zip(self.offsets_nd, self.weights):
            if len(off) != len(self.shape_nd):
                raise ValueError(f"offset {off} rank != grid rank")
            dc = off[-1]
            dr = sum(o * st for o, st in zip(off[:-1], strides))
            if abs(dc) >= self.ny:
                raise ValueError(f"offset {off}: |last-dim step| must be < ny")
            constraints = tuple(
                (st, n, o) for o, st, n in zip(off[:-1], strides, row_axes) if o != 0
            )
            bands.append((dr, dc, w, constraints))
        self.bands = tuple(bands)
        # with zero rows outside the grid, a constraint on an axis spanning
        # all rows is redundant
        self.kernel_bands = tuple(
            (dr, dc, w, tuple(c for c in cons if c[0] * c[1] < self._M))
            for dr, dc, w, cons in self.bands
        )
        self.hermitian = set(
            (tuple(-o for o in off), w) for off, w in zip(self.offsets_nd, self.weights)
        ) == set(zip(self.offsets_nd, self.weights))

    @property
    def shape(self):
        n = self._M * self.ny
        return (n, n)

    @property
    def grid(self):
        return (self._M, self.ny)

    vector_shape = grid

    @property
    def nnz(self):
        # valid positions per band = prod over axes of (n_k - |off_k|)
        total = 0
        for off in self.offsets_nd:
            cnt = 1
            for o, n in zip(off, self.shape_nd):
                cnt *= max(0, n - abs(o))
            total += cnt
        return total

    def _apply_grid(self, x, row0=None, top_halo=None, bot_halo=None):
        """Matvec on the ``(M, ny)`` grid view, or a ``(B, M, ny)`` batch.

        ``row0`` is the slab's first global row (the masks are defined on
        global rows) and the halos are the neighbour slabs' boundary rows
        (``(h_caller, ny)`` with ``h_caller >= h``; the rows next to the
        grid are kept).  Without them the kernel masks with
        ``kernel_bands``, otherwise with the full ``bands``.
        """
        h = cuda_stencil.halo_rows([b[0] for b in self.bands])
        trim_t = None if top_halo is None or h == 0 else top_halo[-h:]
        trim_b = None if bot_halo is None or h == 0 else bot_halo[:h]
        plain = row0 is None and trim_t is None and trim_b is None
        return cuda_stencil.const_stencil2d_matvec(
            x.contiguous(), self.kernel_bands if plain else self.bands,
            row0=row0, top_halo=trim_t, bot_halo=trim_b,
        )

    def __matmul__(self, x):
        M, ny = self.grid
        if x.ndim == 2 and tuple(x.shape) == (M, ny):
            return self._apply_grid(x)
        if x.ndim == 2:
            # multi-RHS (N, k): the kernel's batch dimension runs the columns
            k = x.shape[1]
            return self._apply_grid(x.T.reshape(k, M, ny)).reshape(k, M * ny).T
        if x.ndim == 3 and tuple(x.shape[:2]) == (M, ny):
            # grid-shaped blocked RHS (M, ny, k)
            return self._apply_grid(x.permute(2, 0, 1)).permute(1, 2, 0)
        if x.ndim != 1:
            raise ValueError(f"unsupported vector shape {tuple(x.shape)}")
        return self._apply_grid(x.reshape(M, ny)).reshape(x.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        adj = ConstStencilOperator(
            self.shape_nd,
            tuple(tuple(-o for o in off) for off in self.offsets_nd),
            self.weights,  # real weights: their conjugates
            dtype=self.dtype,
            device=self.device,
        )
        return adj @ x

    def diagonal(self):
        w0 = sum(w for off, w in zip(self.offsets_nd, self.weights)
                 if all(o == 0 for o in off))
        return torch.full((self.shape[0],), float(w0), dtype=self.dtype,
                          device=self.device)

    def toscipy(self):
        """Host-side scipy CSR twin (set-up and analysis paths only)."""
        import scipy.sparse

        nd = self.shape_nd
        N = self._M * self.ny
        idx = np.arange(N)
        coords = np.stack(np.unravel_index(idx, nd), axis=0)
        strides = [int(np.prod(nd[k + 1 :])) for k in range(len(nd))]
        rows, cols, vals = [], [], []
        for off, w in zip(self.offsets_nd, self.weights):
            valid = np.ones(N, dtype=bool)
            for k, o in enumerate(off):
                valid &= (coords[k] + o >= 0) & (coords[k] + o < nd[k])
            j = idx + sum(o * s for o, s in zip(off, strides))
            rows.append(idx[valid])
            cols.append(j[valid])
            vals.append(np.full(valid.sum(), w))
        return scipy.sparse.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(N, N),
        )

    def tocsr(self):
        from .sparse import CSROperator

        return CSROperator.from_scipy(self.toscipy(), device=self.device)

    def tree_flatten(self):
        # the weights are static, as the reference's: no leaves
        return (), (self.shape_nd, self.offsets_nd, self.weights, self.dtype,
                    self.device)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape_nd, offsets_nd, weights, dtype, device = aux
        return cls(shape_nd, offsets_nd, weights, dtype=dtype, device=device)


def _laplace_offsets(nd):
    offs = [tuple([0] * nd)]
    ws = [2.0 * nd]
    for k in range(nd):
        for s in (+1, -1):
            o = [0] * nd
            o[k] = s
            offs.append(tuple(o))
            ws.append(-1.0)
    return tuple(offs), tuple(ws)


def poisson_2d_const(nx, ny=None, dtype=np.float32, device=None):
    """5-point 2-D Laplacian as a constant-coefficient stencil (no
    coefficient arrays)."""
    ny = nx if ny is None else ny
    offs, ws = _laplace_offsets(2)
    return ConstStencilOperator((nx, ny), offs, ws, dtype=dtype, device=device)


def poisson_3d_const(nx, ny=None, nz=None, dtype=np.float32, device=None):
    """7-point 3-D Laplacian as a constant-coefficient stencil."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    offs, ws = _laplace_offsets(3)
    return ConstStencilOperator((nx, ny, nz), offs, ws, dtype=dtype, device=device)
