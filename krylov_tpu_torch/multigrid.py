"""Geometric multigrid V-cycle preconditioner for stencil operators.

Counterpart of ``krylov_tpu.multigrid.MultigridPreconditioner`` (single
device).  One V(s, s) cycle per application, used as the SPD ``M`` of CG:
iteration counts on the 2-D Poisson problem drop from O(n) to about ten.

Per level, on a CUDA device:

* smoothing and residual steps are one fused damped-Jacobi sweep each:
  kernel K8 (:func:`cuda_stencil.jacobi_sweep_const`) on the rediscretized
  const levels, K9 (:func:`cuda_stencil.jacobi_sweep_var`) on the Galerkin
  levels of a variable-coefficient operator.  Each sweep writes into the
  other of two buffers of its level (a sweep reads its input's neighbour
  rows, so it cannot write in place);
* restriction and prolongation are plain torch (the reference computes
  them in XLA too): cell-centred multilinear interpolation, order 2, with
  its exact transpose as restriction;
* the coarsest level is a dense inverse applied by ``torch.tensordot``
  when it has at most 4096 points, else ``coarse_iters`` sweeps.

Scaling: the unit-spacing stencil is reused on every const level, so the
restriction carries ``h_c^2 / h^2 = 4`` in its scale ``4 / 2^d``; Galerkin
levels are exact ``P^T A P`` and restrict with ``P^T`` alone.  The
Galerkin set-up is one host-side scipy pass; scipy is imported there and
only there.
"""

import numpy as np
import torch

from .ops import cuda_stencil
from .ops.stencil import ConstStencilOperator, GridStencilOperator


def _halve_all(shape_nd):
    return tuple(s // 2 for s in shape_nd)


def _can_halve(shape_nd, min_side=4):
    return all(s % 2 == 0 and s // 2 >= min_side for s in shape_nd)


# -- order-2 (cell-centred multilinear) transfer --------------------------
#
# 1-D weights 3/4, 1/4 toward the nearer / farther coarse neighbour; the
# walls use the Dirichlet ghost c[-1] = -c[0].  Restriction is the exact
# adjoint of prolongation (ghost terms included), which keeps the cycle
# with equal pre- and post-smoothing symmetric, as CG needs.


def _lin_prolong_axis(x, ax):
    m = x.shape[ax]
    cm = torch.cat([-x.narrow(ax, 0, 1), x.narrow(ax, 0, m - 1)], dim=ax)
    cp = torch.cat([x.narrow(ax, 1, m - 1), -x.narrow(ax, m - 1, 1)], dim=ax)
    even = 0.75 * x + 0.25 * cm
    odd = 0.75 * x + 0.25 * cp
    y = torch.stack([even, odd], dim=ax + 1)
    return y.reshape(x.shape[:ax] + (2 * m,) + x.shape[ax + 1 :])


def _lin_prolong(x, nd):
    """Cell-centred multilinear interpolation over the leading nd axes."""
    for ax in range(nd):
        x = _lin_prolong_axis(x, ax)
    return x


def _lin_restrict_axis(x, ax):
    m = x.shape[ax] // 2
    xr = x.reshape(x.shape[:ax] + (m, 2) + x.shape[ax + 1 :])
    even, odd = xr.select(ax + 1, 0), xr.select(ax + 1, 1)
    zero = torch.zeros_like(even.narrow(ax, 0, 1))
    even_next = torch.cat([even.narrow(ax, 1, m - 1), zero], dim=ax)
    odd_prev = torch.cat([zero, odd.narrow(ax, 0, m - 1)], dim=ax)
    t = 0.75 * (even + odd) + 0.25 * even_next + 0.25 * odd_prev
    # exact adjoint of the Dirichlet ghost terms at the two walls
    tf = t.narrow(ax, 0, 1) - 0.25 * even.narrow(ax, 0, 1)
    tl = t.narrow(ax, m - 1, 1) - 0.25 * odd.narrow(ax, m - 1, 1)
    return torch.cat([tf, t.narrow(ax, 1, m - 2), tl], dim=ax)


def _lin_restrict(x, nd, scale):
    """Exact transpose of :func:`_lin_prolong`, scaled (full weighting)."""
    for ax in range(nd):
        x = _lin_restrict_axis(x, ax)
    return x * scale


def _bilinear_P_1d(m):
    """The 1-D cell-centred linear prolongation (2m, m) as scipy CSR: the
    explicit-matrix twin of :func:`_lin_prolong_axis`, for the Galerkin
    triple product ``P^T A P``."""
    import scipy.sparse

    rows, cols, vals = [], [], []
    for i in range(m):
        rows += [2 * i, 2 * i + 1]
        cols += [i, i]
        vals += [0.75, 0.75]
        # even neighbour (i-1); the Dirichlet ghost folds -1/4 onto i at the wall
        rows.append(2 * i)
        cols.append(i - 1 if i > 0 else 0)
        vals.append(0.25 if i > 0 else -0.25)
        # odd neighbour (i+1)
        rows.append(2 * i + 1)
        cols.append(i + 1 if i < m - 1 else m - 1)
        vals.append(0.25 if i < m - 1 else -0.25)
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(2 * m, m))


def _scipy_to_planes(A_sp, mx, my):
    """Split a (mx*my, mx*my) scipy grid operator into coefficient planes
    ``(ndiag, mx, my)`` keyed by 2-D offsets (dr, dc)."""
    coo = A_sp.tocoo()
    I, J = coo.row // my, coo.row % my
    dr = coo.col // my - I
    dc = coo.col % my - J
    keys = sorted(set(zip(dr.tolist(), dc.tolist())))
    planes = np.zeros((len(keys), mx, my), A_sp.dtype)
    for k, (a, b) in enumerate(keys):
        sel = (dr == a) & (dc == b)
        planes[k][I[sel], J[sel]] = coo.data[sel]
    return planes, tuple(k[0] for k in keys), tuple(k[1] for k in keys)


def _dense_inverse(dense):
    try:
        return np.linalg.inv(dense)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(dense)


class MultigridPreconditioner:
    """``z = M @ r`` runs one geometric V-cycle approximating ``A^{-1} r``.

    * ``A`` — a :class:`ConstStencilOperator` (any rank >= 2; each coarse
      level rediscretizes the same weights on the halved grid) or a
      hermitian 2-D :class:`GridStencilOperator` with row and column
      offsets in [-2, 2] (each coarse level is the exact Galerkin product
      ``P^T A P`` for the bilinear transfer, computed once on the host:
      5-point fine stencils become 25-point coarse ones).
    * ``smooth`` — pre- and post-smoothing sweeps of weighted Jacobi.
    * ``omega`` — Jacobi damping (0.8 suits the 5/7-point Laplacian).
    * ``n_levels`` — cap on the hierarchy depth (default: halve while all
      dims stay even and >= 4).
    * ``coarse_iters`` — Jacobi sweeps on a coarsest grid too large for
      the dense inverse.

    Accepts flat ``(N,)``, grid-shaped ``(M, ny)`` and blocked ``(..., k)``
    right-hand sides (trailing axes ride along; their smoothing runs as a
    stencil matvec plus elementwise torch, as the reference's does).  The
    hierarchy's tensors live on ``A.device``.
    """

    hermitian = True

    def __init__(self, A, smooth=2, omega=0.8, n_levels=None, coarse_iters=40):
        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)
        self._coarse_inv = None
        dev = A.device

        def can_coarsen(shapes):
            return _can_halve(shapes[-1]) and (n_levels is None or len(shapes) < n_levels)

        if isinstance(A, ConstStencilOperator):
            shapes = [A.shape_nd]
            while can_coarsen(shapes):
                shapes.append(_halve_all(shapes[-1]))
            ops = [A] + [
                ConstStencilOperator(s, A.offsets_nd, A.weights, A.dtype, device=dev)
                for s in shapes[1:]
            ]
            center = [w for off, w in zip(A.offsets_nd, A.weights)
                      if all(o == 0 for o in off)]
            if not center or center[0] == 0.0:
                raise ValueError("stencil needs a nonzero center weight")
            # the Jacobi weight rounded to the operator's dtype, as a host float
            winv = [float(torch.tensor(self.omega / center[0], dtype=A.dtype))] * len(ops)
            # rediscretized levels reuse the unit-spacing stencil, so the
            # restriction carries the h_c^2 / h^2 factor
            r_scale = 4.0 / (2 ** len(A.shape_nd))
            if int(np.prod(shapes[-1])) <= 4096 and len(ops) > 1:
                # exact coarsest solve (tiny dense inverse)
                dense = np.asarray(ops[-1].toscipy().toarray(), dtype=np.float64)
                self._coarse_inv = torch.tensor(_dense_inverse(dense), dtype=A.dtype,
                                                device=dev)
        elif isinstance(A, GridStencilOperator):
            if not A.hermitian:
                raise ValueError(
                    "multigrid preconditioning needs a hermitian (SPD) operator "
                    "(the cycle advertises hermitian=True)"
                )
            if any(o not in (-2, -1, 0, 1, 2) for o in A.row_offsets + A.col_offsets):
                raise ValueError(
                    "Galerkin multigrid supports 2-D stencils with row/col offsets "
                    f"in [-2, 2]; got {A.row_offsets}/{A.col_offsets}"
                )
            import scipy.sparse

            # exact variational hierarchy A_c = P^T A P, bilinear P.  Each
            # level keeps scipy's (dr, dc) pairs: on a level with ny = 4 two
            # of them share a flat offset
            np_dtype = A.coeffs2d.cpu().numpy().dtype
            ops, shapes = [A], [tuple(A.grid)]
            A_sp = A.toscipy().astype(np.float64)
            while can_coarsen(shapes):
                mx, my = shapes[-1]
                P = scipy.sparse.kron(_bilinear_P_1d(mx // 2), _bilinear_P_1d(my // 2),
                                      format="csr")
                A_sp = (P.T @ A_sp @ P).tocsr()
                cc, ro, co = _scipy_to_planes(A_sp, mx // 2, my // 2)
                ops.append(GridStencilOperator(
                    torch.from_numpy(cc.astype(np_dtype)).to(dev), None, my // 2,
                    hermitian=True, row_col_offsets=(ro, co),
                ))
                shapes.append((mx // 2, my // 2))
            # per-level Jacobi weight planes from each level's own diagonal
            winv = []
            for op in ops:
                d = op.diagonal().reshape(op.grid)
                winv.append(torch.tensor(self.omega, dtype=d.dtype, device=dev)
                            / torch.where(d != 0, d, 1.0))
            r_scale = 1.0  # Galerkin R = P^T: no rescaling
            if shapes[-1][0] * shapes[-1][1] <= 4096:
                # exact coarse solve as one dense matmul
                inv = _dense_inverse(A_sp.toarray())
                self._coarse_inv = torch.from_numpy(inv.astype(np_dtype)).to(dev)
        else:
            raise TypeError(
                "MultigridPreconditioner needs a ConstStencilOperator or a 2-D "
                "GridStencilOperator"
            )
        self._nd_shapes = tuple(tuple(s) for s in shapes)
        self._r_scale = r_scale
        self._ops = tuple(ops)
        self._winv = tuple(winv)

    @classmethod
    def from_parts(cls, ops, winv, coarse_inv, nd_shapes, r_scale, smooth=2,
                   omega=0.8, coarse_iters=40):
        """A cycle over a given hierarchy: per level the operator and its
        Jacobi weight (a float for const levels, an ``(M, ny)`` plane for
        grid levels), and the coarsest level's dense inverse or None."""
        self = object.__new__(cls)
        self.smooth, self.omega = int(smooth), float(omega)
        self.coarse_iters = int(coarse_iters)
        self._ops, self._winv = tuple(ops), tuple(winv)
        self._coarse_inv = coarse_inv
        self._nd_shapes = tuple(tuple(s) for s in nd_shapes)
        self._r_scale = float(r_scale)
        return self

    # -- observables -----------------------------------------------------
    @property
    def shape(self):
        return self._ops[0].shape

    @property
    def dtype(self):
        return self._ops[0].dtype

    @property
    def n_levels(self):
        return len(self._ops)

    # -- smoothing ---------------------------------------------------------
    def _wmul(self, level, r):
        w = self._winv[level]
        if isinstance(w, float):
            return w * r
        return w.reshape(tuple(w.shape) + (1,) * (r.ndim - w.ndim)) * r

    def _sweep(self, level, z, r, update, out=None):
        """One fused sweep (K8 or K9) on a single right-hand side:
        ``z + w (r - A z)`` or ``r - A z``, written into ``out``."""
        op = self._ops[level]
        g = op.vector_shape
        out2 = None if out is None else out.reshape(g)
        if isinstance(op, ConstStencilOperator):
            y = cuda_stencil.jacobi_sweep_const(
                self._winv[level], z.reshape(g), r.reshape(g), op.kernel_bands,
                update=update, out=out2,
            )
        else:
            y = cuda_stencil.jacobi_sweep_var(
                self._winv[level], z.reshape(g), r.reshape(g), op.coeffs2d,
                op.row_offsets, op.col_offsets, update=update, out=out2,
            )
        return y.reshape(z.shape)

    def _single(self, level, x_nd):
        """Whether ``x_nd`` is one right-hand side (no trailing axes)."""
        return x_nd.ndim == len(self._nd_shapes[level])

    def _smooth(self, level, z, r, iters, spare):
        """``iters`` damped-Jacobi sweeps from ``z``, alternating between
        ``z`` and ``spare``; returns ``(z, spare)``."""
        for _ in range(iters):
            if self._single(level, z):
                z, spare = self._sweep(level, z, r, True, out=spare), z
            else:
                z = z + self._wmul(level, r - self._apply(level, z))
        return z, spare

    def _residual(self, level, z, r):
        """``r - A z``, one fused pass for a single right-hand side."""
        if self._single(level, z):
            return self._sweep(level, z, r, False)
        return r - self._apply(level, z)

    def _apply(self, level, x_nd):
        # the operator works on the collapsed (M, ny)(+tail) view
        op = self._ops[level]
        tail = tuple(x_nd.shape[len(self._nd_shapes[level]):])
        return (op @ x_nd.reshape(tuple(op.vector_shape) + tail)).reshape(x_nd.shape)

    # -- the cycle ---------------------------------------------------------
    def _vcycle(self, level, r):
        sh = self._nd_shapes[level]
        if level == len(self._ops) - 1:
            if self._coarse_inv is not None:
                r2 = r.reshape((int(np.prod(sh)),) + tuple(r.shape[len(sh):]))
                dt = torch.promote_types(self._coarse_inv.dtype, r2.dtype)
                z2 = torch.tensordot(self._coarse_inv.to(dt), r2.to(dt), dims=1)
                return z2.reshape(r.shape)
            z, _ = self._smooth(level, torch.zeros_like(r), r, self.coarse_iters,
                                torch.empty_like(r))
            return z
        nd = len(sh)
        z = self._wmul(level, r)  # first sweep from zero, no matvec
        z, spare = self._smooth(level, z, r, self.smooth - 1, torch.empty_like(z))
        d = self._residual(level, z, r)
        e = self._vcycle(level + 1, _lin_restrict(d, nd, self._r_scale))
        z = z + _lin_prolong(e, nd)
        z, _ = self._smooth(level, z, r, self.smooth, spare)
        return z

    def __matmul__(self, r):
        g = self._ops[0].vector_shape  # (M, ny)
        if r.ndim >= 2 and tuple(r.shape[:2]) == tuple(g):
            tail = tuple(r.shape[2:])
        else:  # flat (N,)(+tail)
            tail = tuple(r.shape[1:])
        z = self._vcycle(0, r.reshape(self._nd_shapes[0] + tail))
        return z.reshape(r.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle
