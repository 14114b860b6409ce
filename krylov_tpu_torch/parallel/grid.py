"""Row-partitioned grid-stencil operators: the fast distributed matvec.

Counterpart of ``krylov_tpu.parallel.grid``.  For operators that factor over
a grid (:class:`~krylov_tpu_torch.ops.stencil.GridStencilOperator`,
:class:`~krylov_tpu_torch.ops.stencil.ConstStencilOperator`) each rank keeps
its slab in the 2-D ``(M_local, ny)`` layout, exchanges ``h = max|row
offset|`` grid rows with its neighbours and runs the single-device kernel
(K1, :func:`krylov_tpu_torch.ops.cuda_stencil.stencil2d_matvec`, or K2 for
the constant stencil) with the neighbours' rows as its halo rows.  Per
iteration the only traffic between ranks is ``2 * h * ny`` elements each
way plus the solver's reduced scalars.

Vectors are grid-shaped ``(M_local, ny)`` locally, or ``(M_local, ny, k)``
for a blocked right-hand side; a full-contraction reduced inner product
goes with them (:func:`krylov_tpu_torch.parallel.sharded_solve` wires it
for these operators).
"""

import torch

from ..ops.stencil import GridStencilOperator
from .mesh import ROWS


def _halo_rows(row_offsets):
    """Grid rows a rank exchanges with each neighbour: ``max |dr|``, at
    least one (the reference's width)."""
    return max(max(0, -min(row_offsets)), max(0, max(row_offsets)), 1)


def _batched(x2):
    """``x2`` as a ``(B, M, ny)`` batch: ``(1, M, ny)`` for one grid, the
    columns of a blocked ``(M, ny, k)`` one first."""
    return x2[None] if x2.ndim == 2 else x2.permute(2, 0, 1).contiguous()


def _unbatched(yb, ndim):
    return yb[0] if ndim == 2 else yb.permute(1, 2, 0)


def _joined(ys, ndim):
    """Per-column results as one ``(M, ny)`` or ``(M, ny, k)`` tensor (no
    copy for one grid)."""
    return ys[0] if ndim == 2 else torch.stack(ys, dim=-1)


class ShardedGridStencilOperator:
    """Local grid-row slab of a :class:`GridStencilOperator`.

    ``coeffs2d``: the local ``(ndiag, M_local, ny)`` block, a plain slice of
    the global coefficients along the grid-row axis.  ``row_col_offsets``
    gives each band's 2-D offset directly, as for the single-device
    operator.
    """

    def __init__(self, coeffs2d, offsets, ny, mesh, axis=ROWS, hermitian=False,
                 row_col_offsets=None):
        self._local = GridStencilOperator(coeffs2d, offsets, ny, hermitian=hermitian,
                                          row_col_offsets=row_col_offsets)
        self.mesh = mesh
        self.axis = axis
        h, M = self.halo_rows, self.grid[0]
        rc = (self._local.row_offsets, self._local.col_offsets)
        c2 = self._local.coeffs2d
        # the first and last h rows, recomputed once the halos are in
        self._strips = None if 2 * h >= M else tuple(
            GridStencilOperator(c2[:, rows].contiguous(), None, ny, hermitian=hermitian,
                                row_col_offsets=rc)
            for rows in (slice(0, h), slice(M - h, M))
        )

    @property
    def coeffs2d(self):
        return self._local.coeffs2d

    @property
    def offsets(self):
        return self._local.offsets

    @property
    def ny(self):
        return self._local.ny

    @property
    def hermitian(self):
        return self._local.hermitian

    @property
    def dtype(self):
        return self.coeffs2d.dtype

    @property
    def device(self):
        return self.coeffs2d.device

    @property
    def grid(self):
        return self._local.grid

    vector_shape = grid

    @property
    def shape(self):
        n_local = self.grid[0] * self.grid[1]
        return (n_local, n_local)

    @property
    def halo_rows(self):
        return _halo_rows(self._local.row_offsets)

    def start_exchange(self, xb):
        """Send the slab's edge rows of a ``(B, M, ny)`` batch to the
        neighbours; ``wait()`` gives ``(top, bot)``, the previous rank's
        last ``h`` rows and the next rank's first ``h`` (zeros at the
        edges of the mesh)."""
        h = self.halo_rows
        if h > xb.shape[-2]:
            raise ValueError(f"halo {h} grid rows exceeds local rows {xb.shape[-2]}")
        return self.mesh.start_exchange(xb[:, -h:], xb[:, :h], self.axis)

    def __matmul__(self, x2):
        """Halo exchange overlapped with the local matvec.

        K1 runs on the whole slab with zero halos while the two halo
        transfers are in flight; then the ``h`` boundary rows on each side
        that has a neighbour are recomputed by K1 from the received halos
        (O(h * ny) work).  A
        slab too thin to split waits for the halos and runs K1 once with
        them; a rank alone on its axis runs the single-device matvec.  A
        blocked ``(M_local, ny, k)`` right-hand side exchanges its
        edge rows once and runs K1's batched form on the slab.
        """
        if x2.ndim not in (2, 3) or tuple(x2.shape[:2]) != self.grid:
            raise ValueError(f"x {tuple(x2.shape)} is not on the local grid {self.grid}")
        if self.mesh.alone(self.axis):
            return self._local @ x2  # alone on the axis: nothing to exchange
        xb = _batched(x2.contiguous())
        pending = self.start_exchange(xb)
        if self._strips is None:
            top, bot = pending.wait()
            return _joined([
                self._local._apply_grid(xb[j], top_halo=top[j], bot_halo=bot[j])
                for j in range(xb.shape[0])
            ], x2.ndim)
        yb = self._local._apply_grid(xb)  # overlaps with the transfers
        top, bot = pending.wait()
        h, M = self.halo_rows, self.grid[0]
        first, last = self._strips
        # a side with no neighbour has zero halos, which the slab's K1 used
        has_prev, has_next = self.mesh.neighbours(self.axis)
        for j in range(xb.shape[0]):
            # rows [0, h) read rows [-h, 2h); rows [M-h, M) read [M-2h, M+h)
            if has_prev:
                yb[j, :h] = first._apply_grid(xb[j, :h], top_halo=top[j],
                                              bot_halo=xb[j, h : 2 * h])
            if has_next:
                yb[j, M - h :] = last._apply_grid(xb[j, M - h :],
                                                  top_halo=xb[j, M - 2 * h : M - h],
                                                  bot_halo=bot[j])
        return _unbatched(yb, x2.ndim)

    matvec = __matmul__

    def rmatvec(self, x2):
        if self.hermitian:
            return self @ x2
        raise NotImplementedError(
            "sharded grid-stencil adjoint matvec: only hermitian operators "
            "are supported (CG/MINRES/GMRES need no rmatvec)"
        )

    def diagonal(self):
        return self._local.diagonal()


class ShardedConstStencilOperator:
    """Local grid-row slab of a :class:`ConstStencilOperator`.

    No arrays at all: the global operator's static weights and the slab's
    first global row ``coord * m_local``.  Halo rows travel as for the
    variable-coefficient operator; K2's Dirichlet masks use global rows.
    ``m_valid``: the global count of real grid rows when the grid was
    padded to the shard multiple; output rows at or past it are zero, so
    the padded entries of every solver vector stay exactly zero.
    """

    def __init__(self, op, m_local, mesh, axis=ROWS, m_valid=None):
        self._op = op
        self.m_local = int(m_local)
        self.mesh = mesh
        self.axis = axis
        self.m_valid = None if m_valid is None else int(m_valid)

    @property
    def dtype(self):
        return self._op.dtype

    @property
    def device(self):
        return self.mesh.device

    @property
    def grid(self):
        return (self.m_local, self._op.ny)

    vector_shape = grid

    @property
    def hermitian(self):
        return self._op.hermitian

    @property
    def shape(self):
        n_local = self.m_local * self._op.ny
        return (n_local, n_local)

    @property
    def halo_rows(self):
        return _halo_rows(tuple(b[0] for b in self._op.bands))

    @property
    def row0(self):
        return self.mesh.coord[self.axis] * self.m_local

    def __matmul__(self, x2):
        if x2.ndim not in (2, 3) or tuple(x2.shape[:2]) != self.grid:
            raise ValueError(f"x {tuple(x2.shape)} is not on the local grid {self.grid}")
        if self.mesh.alone(self.axis):
            return self._op @ x2  # alone on the axis: no halos, no padded rows
        h = self.halo_rows
        if h > self.m_local:
            raise ValueError(f"halo {h} grid rows exceeds local rows {self.m_local}")
        xb = _batched(x2.contiguous())
        top, bot = self.mesh.start_exchange(xb[:, -h:], xb[:, :h], self.axis).wait()
        row0 = self.row0
        y = _joined([
            self._op._apply_grid(xb[j], row0=row0, top_halo=top[j], bot_halo=bot[j])
            for j in range(xb.shape[0])
        ], x2.ndim)
        if self.m_valid is not None and row0 + self.m_local > self.m_valid:
            # the weights apply at padded rows too; zero them there
            y[max(0, self.m_valid - row0):] = 0
        return y

    matvec = __matmul__

    def rmatvec(self, x2):
        if self.hermitian:
            return self @ x2
        raise NotImplementedError(
            "sharded const-stencil adjoint: only hermitian operators are "
            "supported (CG/MINRES/GMRES need no rmatvec)"
        )

    def diagonal(self):
        d = float(self._op.diagonal()[0])  # the constant diagonal weight
        return torch.full(self.grid, d, dtype=self.dtype, device=self.device)
