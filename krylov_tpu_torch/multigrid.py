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


# -- piecewise-constant transfer (the sharded Galerkin cycle) ---------------


def _block_restrict(x, nd, scale):
    """Scaled 2x..x2 block sum over the leading ``nd`` axes."""
    for ax in range(nd):
        s = tuple(x.shape)
        x = x.reshape(s[:ax] + (s[ax] // 2, 2) + s[ax + 1 :]).sum(dim=ax + 1)
    return x * scale


def _block_prolong(x, nd):
    """Piecewise-constant interpolation: each cell repeated 2x an axis."""
    for ax in range(nd):
        x = torch.repeat_interleave(x, 2, dim=ax)
    return x


# -- the order-2 transfer along the sharded leading axis --------------------
#
# One boundary plane travels to each mesh neighbour a transfer
# (``Mesh.start_exchange``, zeros at the mesh edges, as the reference's
# ``ppermute``), and the Dirichlet ghost terms apply on the first and last
# rank only: the distributed transfer is the single-device one.


def _edges(mesh, axis):
    """Whether this rank holds the first and the last slab of ``axis``."""
    i = mesh.coord[axis]
    return i == 0, i == mesh.shape[axis] - 1


def _exchange(mesh, axis, to_next, to_prev):
    """``(from_prev, from_next)``; a rank alone on its axis receives zeros
    and sends nothing (:meth:`~krylov_tpu_torch.parallel.mesh.Mesh.alone`)."""
    return mesh.start_exchange(to_next, to_prev, axis).wait()


def _lead_lin_restrict_axis(x, mesh, axis):
    """:func:`_lin_restrict_axis` along the leading, row-partitioned axis."""
    m = x.shape[0] // 2
    xr = x.reshape((m, 2) + tuple(x.shape[1:]))
    even, odd = xr[:, 0], xr[:, 1]
    od_prev, ev_next = _exchange(mesh, axis, odd[-1:], even[:1])
    even_next = torch.cat([even[1:], ev_next])
    odd_prev = torch.cat([od_prev, odd[:-1]])
    t = 0.75 * (even + odd) + 0.25 * even_next + 0.25 * odd_prev
    first, last = _edges(mesh, axis)
    if first:  # the exact adjoint of the Dirichlet ghost terms at the walls
        t[:1] += -0.25 * even[:1]
    if last:
        t[m - 1 :] += -0.25 * odd[-1:]
    return t


def _lead_lin_prolong_axis(x, mesh, axis):
    """:func:`_lin_prolong_axis` along the leading, row-partitioned axis."""
    c_prev, c_next = _exchange(mesh, axis, x[-1:], x[:1])
    first, last = _edges(mesh, axis)
    if first:
        c_prev = -x[:1]
    if last:
        c_next = -x[-1:]
    even = 0.75 * x + 0.25 * torch.cat([c_prev, x[:-1]])
    odd = 0.75 * x + 0.25 * torch.cat([x[1:], c_next])
    return torch.stack([even, odd], dim=1).reshape((2 * x.shape[0],) + tuple(x.shape[1:]))


def _sharded_lin_restrict(x, nd, scale, mesh, axis):
    x = _lead_lin_restrict_axis(x, mesh, axis)
    for ax in range(1, nd):
        x = _lin_restrict_axis(x, ax)
    return x * scale


def _sharded_lin_prolong(x, nd, mesh, axis):
    x = _lead_lin_prolong_axis(x, mesh, axis)
    for ax in range(1, nd):
        x = _lin_prolong_axis(x, ax)
    return x


def _galerkin_coarsen_2d(coeffs, row_offsets, col_offsets):
    """Exact Galerkin coarse stencil ``A_c = P^T A P`` for piecewise-constant
    transfer (``P`` the 2x2 block repeat, ``R = P^T`` the block sum).

    ``coeffs``: ``(ndiag, Mx, My)`` fine coefficient planes (numpy or a
    tensor).  Fine entry ``(i, i + d)`` with ``i = 2I + p`` lands at coarse
    offset ``floor((p + d) / 2)`` a dimension, position ``I``: each fine
    plane sums into the coarse planes by parity sub-sampling.  Returns
    ``(coarse_coeffs, coarse_row_offsets, coarse_col_offsets)``, keyed by
    ``(dr, dc)`` pairs in ascending order; the fine boundary contract (zero
    coefficients where the neighbour leaves the grid) carries over exactly.
    """
    out = {}
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        C = coeffs[d]
        for px in (0, 1):
            for py in (0, 1):
                key = ((px + dr) // 2, (py + dc) // 2)
                sub = C[px::2, py::2]
                out[key] = sub if key not in out else out[key] + sub
    keys = sorted(out)
    stack = np.stack if isinstance(coeffs, np.ndarray) else torch.stack
    cc = stack([out[k] for k in keys], 0)
    return cc, tuple(k[0] for k in keys), tuple(k[1] for k in keys)


class ShardedMultigridPreconditioner:
    """Distributed geometric V-cycle over a row-sharded constant stencil
    (built by :func:`multigrid_factory` on the rank's
    :class:`~krylov_tpu_torch.parallel.grid.ShardedConstStencilOperator`).

    Per level:

    * smoothing and residuals: the level's
      :class:`~krylov_tpu_torch.parallel.grid.ShardedConstStencilOperator`
      (K2 on the slab with ``row0`` and the neighbours' halo rows; one
      exchange a sweep, no reduction);
    * restriction and prolongation: the order-2 multilinear transfer, one
      boundary plane exchanged with each neighbour along the sharded axis,
      the other axes local;
    * the coarsest level: once a slab can no longer halve, the small coarse
      residual is gathered (``all_gather_rows``) and every rank runs the
      same single-device :class:`MultigridPreconditioner` V-cycle (K8) on
      the global coarse grid, then keeps its own rows.

    The cycle couples the slabs at every level, so iteration counts match
    the single-device V-cycle whatever the rank count.
    """

    hermitian = True

    def __init__(self, A_l, smooth=2, omega=0.8, n_levels=None, coarse_iters=40):
        from .parallel.grid import ShardedConstStencilOperator

        if not isinstance(A_l, ShardedConstStencilOperator):
            raise TypeError("ShardedMultigridPreconditioner needs a ShardedConstStencilOperator")
        if A_l.m_valid is not None:
            raise ValueError(
                "padded grids cannot coarsen consistently across shards; use "
                "multigrid_factory(coupling='local')"
            )
        g = A_l._op
        inner_rows = int(np.prod(g.shape_nd[1:-1]))
        if A_l.m_local % inner_rows:
            raise ValueError(
                f"shard slab of {A_l.m_local} grid rows does not tile the inner grid dims "
                f"{g.shape_nd[1:-1]}"
            )
        self.mesh, self.axis = A_l.mesh, A_l.axis
        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)

        shapes, leads = [g.shape_nd], [A_l.m_local // inner_rows]
        # halve while every slab keeps whole leading cells and the unsharded
        # dims stay halvable
        while (leads[-1] % 2 == 0 and _can_halve(shapes[-1][1:])
               and (n_levels is None or len(shapes) < n_levels)):
            shapes.append(_halve_all(shapes[-1]))
            leads.append(leads[-1] // 2)
        dev = A_l.device
        ops = [ConstStencilOperator(s, g.offsets_nd, g.weights, g.dtype, device=dev)
               for s in shapes]
        self._leads = tuple(leads)
        self._nds = tuple(len(s) for s in shapes)
        self._local_nd = tuple((lead,) + tuple(s[1:]) for lead, s in zip(leads, shapes))
        # every level's slab operator, made once
        self._slabs = tuple(
            ShardedConstStencilOperator(op, lead * int(np.prod(s[1:-1])), self.mesh, self.axis)
            for op, lead, s in zip(ops, leads, shapes)
        )
        # the gathered coarse solve: one single-device V-cycle on the global
        # coarse grid (which keeps coarsening below the slabs' limit)
        self._coarse = MultigridPreconditioner(ops[-1], smooth=smooth, omega=omega,
                                               coarse_iters=coarse_iters)
        center = [w for off, w in zip(g.offsets_nd, g.weights) if all(o == 0 for o in off)]
        if not center or center[0] == 0.0:
            raise ValueError("stencil needs a nonzero center weight")
        self._w = self.omega / float(center[0])
        self._r_scale = 4.0 / (2 ** len(g.shape_nd))
        self._dtype = g.dtype

    @property
    def dtype(self):
        return self._dtype

    @property
    def n_levels(self):
        return len(self._slabs) + self._coarse.n_levels - 1

    def _apply(self, level, x_nd):
        """The level's sharded matvec in the slab's n-D layout."""
        sh = self._slabs[level]
        tail = tuple(x_nd.shape[self._nds[level]:])
        return (sh @ x_nd.reshape(tuple(sh.grid) + tail)).reshape(x_nd.shape)

    def _smooth(self, level, z, r, iters):
        for _ in range(iters):
            z = z + self._w * (r - self._apply(level, z))
        return z

    def _vcycle(self, level, r):
        nd = self._nds[level]
        if level == len(self._slabs) - 1:
            rg = self.mesh.all_gather_rows(r, self.axis)
            zg = self._coarse._vcycle(0, rg)
            lead = self._leads[level]
            row0 = self.mesh.coord[self.axis] * lead
            return zg[row0 : row0 + lead]
        z = self._w * r  # the first Jacobi sweep from zero, no matvec
        z = self._smooth(level, z, r, self.smooth - 1)
        d = r - self._apply(level, z)
        e = self._vcycle(level + 1,
                         _sharded_lin_restrict(d, nd, self._r_scale, self.mesh, self.axis))
        z = z + _sharded_lin_prolong(e, nd, self.mesh, self.axis)
        return self._smooth(level, z, r, self.smooth)

    def __matmul__(self, r):
        # r: the slab's collapsed (m_local, last)(+tail) vector
        tail = tuple(r.shape[2:])
        return self._vcycle(0, r.reshape(self._local_nd[0] + tail)).reshape(r.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # a symmetric cycle


class ShardedGalerkinMultigrid:
    """Distributed Galerkin V-cycle over a row-sharded variable-coefficient
    2-D grid stencil (built by :func:`multigrid_factory` on the rank's
    :class:`~krylov_tpu_torch.parallel.grid.ShardedGridStencilOperator`).

    Every level smooths with damped Jacobi through a halo-exchanging
    :class:`~krylov_tpu_torch.parallel.grid.ShardedGridStencilOperator`
    (K1; one exchange a sweep, no reduction).  Each coarse level's
    coefficients are the exact Galerkin product ``P^T A P`` for
    piecewise-constant transfer, computed on each rank from its own slab by
    parity sub-sampling (an even slab row count keeps global and local
    parities equal, and each fine coefficient lives with its row, so no
    coefficient travels).  When the slab can no longer halve, the small
    coarse coefficient planes are gathered, the global problem keeps
    coarsening on every rank, and the bottom is a dense inverse.  All of
    this happens here, once; an application only smooths and transfers.
    """

    hermitian = True

    def __init__(self, A_l, smooth=2, omega=0.8, n_levels=None, coarse_iters=40):
        from .parallel.grid import ShardedGridStencilOperator

        if not isinstance(A_l, ShardedGridStencilOperator):
            raise TypeError("ShardedGalerkinMultigrid needs a ShardedGridStencilOperator")
        if not A_l.hermitian:
            raise ValueError("multigrid preconditioning needs a hermitian (SPD) operator")
        lop = A_l._local
        if any(o not in (-1, 0, 1) for o in lop.row_offsets + lop.col_offsets):
            raise ValueError(
                "Galerkin multigrid supports nearest-neighbor 2-D stencils; got row/col "
                f"offsets {lop.row_offsets}/{lop.col_offsets}"
            )
        self.mesh, self.axis = A_l.mesh, A_l.axis
        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)

        cc, ro, co = lop.coeffs2d, lop.row_offsets, lop.col_offsets
        coeffs, offs = [cc], [(ro, co)]
        while (coeffs[-1].shape[1] % 2 == 0  # the slab's rows halve cleanly
               and coeffs[-1].shape[1] >= 2
               and coeffs[-1].shape[2] % 2 == 0
               and coeffs[-1].shape[2] // 2 >= 4
               and (n_levels is None or len(coeffs) < n_levels)):
            cc, ro, co = _galerkin_coarsen_2d(cc, ro, co)
            coeffs.append(cc)
            offs.append((ro, co))
        self._ops = tuple(
            A_l if i == 0 else ShardedGridStencilOperator(
                c, None, c.shape[2], self.mesh, self.axis, hermitian=True, row_col_offsets=o)
            for i, (c, o) in enumerate(zip(coeffs, offs))
        )
        self._winv = tuple(self._weights(c, o) for c, o in zip(coeffs, offs))

        # the gathered tail: the coarse planes of every slab, coarsened
        # further on every rank down to a dense inverse
        n_sh = self.mesh.shape[self.axis]
        m_loc_c, ny_c = coeffs[-1].shape[1], coeffs[-1].shape[2]
        self._tail_ops, self._tail_winv, self._tail_inv = (), (), None
        if m_loc_c * n_sh * ny_c <= 65536:
            cg = coeffs[-1]
            if n_sh > 1:  # the planes' grid rows are axis 1: gather them as axis 0
                cg = self.mesh.all_gather_rows(cg.movedim(1, 0).contiguous(),
                                               self.axis).movedim(0, 1)
            ro, co = offs[-1]
            t_c, t_o = [cg], [(ro, co)]
            while (t_c[-1].shape[1] * t_c[-1].shape[2] > 256
                   and t_c[-1].shape[1] % 2 == 0
                   and t_c[-1].shape[1] // 2 >= 1
                   and t_c[-1].shape[2] % 2 == 0
                   and t_c[-1].shape[2] // 2 >= 4):
                cg, ro, co = _galerkin_coarsen_2d(cg, ro, co)
                t_c.append(cg)
                t_o.append((ro, co))
            self._tail_ops = tuple(
                GridStencilOperator(c.contiguous(), None, c.shape[2], hermitian=True,
                                    row_col_offsets=o)
                for c, o in zip(t_c, t_o))
            self._tail_winv = tuple(self._weights(c, o) for c, o in zip(t_c, t_o))
            bottom = self._tail_ops[-1]
            if bottom.grid[0] * bottom.grid[1] <= 4096:
                dense = bottom.todense().cpu().numpy()
                self._tail_inv = torch.from_numpy(_dense_inverse(dense)).to(bottom.device)

    def _weights(self, cc, ro_co):
        d = cc[list(zip(*ro_co)).index((0, 0))]
        return self.omega / torch.where(d != 0, d, torch.ones_like(d))

    @property
    def dtype(self):
        return self._ops[0].dtype

    @property
    def n_levels(self):
        return len(self._ops)

    @staticmethod
    def _bcast(w, r):
        return w.reshape(tuple(w.shape) + (1,) * (r.ndim - w.ndim)) * r

    def _smooth(self, level, z, r, iters):
        op = self._ops[level]
        for _ in range(iters):
            z = z + self._bcast(self._winv[level], r - op @ z)
        return z

    # -- the gathered tail (plain K1, no halo exchange) -------------------
    def _tail_apply(self, level, x):
        op = self._tail_ops[level]
        if x.ndim == 3:
            return op._apply_grid(x.permute(2, 0, 1)).permute(1, 2, 0)
        return op._apply_grid(x)

    def _tail_vcycle(self, level, r):
        w = self._tail_winv[level]
        last = level == len(self._tail_ops) - 1
        if last and self._tail_inv is not None:
            sh = tuple(r.shape)
            z2 = torch.tensordot(self._tail_inv, r.reshape((sh[0] * sh[1],) + sh[2:]), dims=1)
            return z2.reshape(sh)
        z = self._bcast(w, r)
        for _ in range(self.coarse_iters - 1 if last else self.smooth - 1):
            z = z + self._bcast(w, r - self._tail_apply(level, z))
        if last:
            return z
        d = r - self._tail_apply(level, z)
        e = self._tail_vcycle(level + 1, _block_restrict(d, 2, 1.0))
        z = z + _block_prolong(e, 2)
        for _ in range(self.smooth):
            z = z + self._bcast(w, r - self._tail_apply(level, z))
        return z

    def _vcycle(self, level, r):
        if level == len(self._ops) - 1:
            if self._tail_ops:
                rg = self.mesh.all_gather_rows(r, self.axis)
                zg = self._tail_vcycle(0, rg)
                m_loc = r.shape[0]
                row0 = self.mesh.coord[self.axis] * m_loc
                return zg[row0 : row0 + m_loc]
            z = self._bcast(self._winv[level], r)
            return self._smooth(level, z, r, self.coarse_iters - 1)
        z = self._bcast(self._winv[level], r)  # the first sweep from zero, no matvec
        z = self._smooth(level, z, r, self.smooth - 1)
        d = r - self._ops[level] @ z
        e = self._vcycle(level + 1, _block_restrict(d, 2, 1.0))
        z = z + _block_prolong(e, 2)
        return self._smooth(level, z, r, self.smooth)

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # a symmetric cycle


class _MultigridFactory:
    """The callable :func:`multigrid_factory` returns (a class, so that it
    pickles to the ranks of a spawned world)."""

    def __init__(self, smooth, omega, n_levels, coarse_iters, coupling):
        if coupling not in ("auto", "full", "local"):
            raise ValueError(f"unknown coupling {coupling!r}")
        self.kw = dict(smooth=smooth, omega=omega, n_levels=n_levels,
                       coarse_iters=coarse_iters)
        self.coupling = coupling

    def __call__(self, A_l):
        if isinstance(A_l, ConstStencilOperator):
            return MultigridPreconditioner(A_l, **self.kw)
        from .parallel.grid import ShardedConstStencilOperator, ShardedGridStencilOperator

        if isinstance(A_l, ShardedGridStencilOperator):
            # variable coefficients: the distributed Galerkin cycle
            if self.coupling == "local":
                raise ValueError(
                    "coupling='local' needs host-side subdomain setup, which "
                    "variable-coefficient slabs cannot do inside shard_map; use "
                    "coupling='full' (the default route)"
                )
            return ShardedGalerkinMultigrid(A_l, **self.kw)
        if not isinstance(A_l, ShardedConstStencilOperator):
            raise TypeError(
                "multigrid_factory needs a (Sharded)ConstStencilOperator or "
                f"ShardedGridStencilOperator; got {type(A_l).__name__} (general sparsity: "
                "AMGPreconditioner)"
            )
        g = A_l._op
        m_local = A_l.m_local
        # the slab's rows slice the collapsed leading grid axis; it is a clean
        # n-D sub-grid iff m_local splits the inner dims
        inner_rows = int(np.prod(g.shape_nd[1:-1]))
        aligned = m_local % inner_rows == 0
        if self.coupling == "full" or (self.coupling == "auto" and aligned
                                       and A_l.m_valid is None):
            return ShardedMultigridPreconditioner(A_l, **self.kw)
        if not aligned:
            raise ValueError(
                f"shard slab of {m_local} grid rows does not tile the inner grid dims "
                f"{g.shape_nd[1:-1]}: choose a mesh whose rows axis divides the leading "
                "grid dimension"
            )
        local = ConstStencilOperator((m_local // inner_rows,) + tuple(g.shape_nd[1:]),
                                     g.offsets_nd, g.weights, g.dtype, device=A_l.device)
        return _ShardLocalMG(MultigridPreconditioner(local, **self.kw), A_l)


def multigrid_factory(smooth=2, omega=0.8, n_levels=None, coarse_iters=40, coupling="auto"):
    """``M_factory`` for :func:`~krylov_tpu_torch.parallel.sharded_solve`: a
    geometric V-cycle over the rank's grid slab.

    * ``coupling="full"``: :class:`ShardedMultigridPreconditioner`, halo
      exchanges in every smoother, slab-local grid transfer, a gathered
      coarse solve; iteration counts match the single-device V-cycle
      whatever the rank count.
    * ``coupling="local"``: additive Schwarz, each rank a
      :class:`MultigridPreconditioner` on its own slab with Dirichlet walls
      at the slab edges; no traffic between ranks, iteration counts grow
      mildly with the rank count.
    * ``coupling="auto"`` (default): "full" where the partition allows it,
      "local" for zero-padded grids.  A slab that does not tile the inner
      grid dims supports neither and raises.

    On a variable-coefficient slab (``ShardedGridStencilOperator``) the
    factory builds :class:`ShardedGalerkinMultigrid` ("local" refuses).  It
    also takes a plain :class:`ConstStencilOperator`, so the same factory
    serves a single-device ``solver(..., M=factory(A))``.
    """
    return _MultigridFactory(smooth, omega, n_levels, coarse_iters, coupling)


class _ShardLocalMG:
    """The slab-local V-cycle with the padded rows masked.

    When the grid was padded to the shard multiple, the sharded matvec keeps
    the padded entries exactly zero; the local V-cycle would leak nonzeros
    into them (its slab operator couples padded and real rows), so its
    output rows at or past ``m_valid`` are zeroed, keeping trajectories
    those of the unpadded problem."""

    hermitian = True

    def __init__(self, mg, A_l):
        self._mg = mg
        self.m_local = int(A_l.m_local)
        self.m_valid = A_l.m_valid
        self._row0 = A_l.row0

    @property
    def shape(self):
        return self._mg.shape

    @property
    def dtype(self):
        return self._mg.dtype

    def __matmul__(self, r):
        z = self._mg @ r
        if self.m_valid is not None and self._row0 + self.m_local > self.m_valid:
            z = z.clone()
            z[max(0, self.m_valid - self._row0):] = 0
        return z

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x
