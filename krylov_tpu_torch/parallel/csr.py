"""Row-partitioned CSR operator.

Counterpart of ``krylov_tpu.parallel.csr``.  The global matrix is split into
contiguous row slabs on the host (:func:`partition_csr`); each shard stores
its rows in COO form padded to a common nnz, and a rank runs the port's
plain CSR product on its slab (:class:`~krylov_tpu_torch.ops.sparse.CSROperator`,
as the reference's XLA form).  Two communication strategies, chosen from
the sparsity pattern:

* ``"halo"``: every off-slab column lies within ``h`` rows of the slab
  (any banded or PDE matrix); columns are remapped to an extended local
  vector ``[left halo | local | right halo]`` filled by one halo exchange;
* ``"gather"``: arbitrary sparsity; the iterate is all-gathered and the
  slab reads global columns.  The adjoint scatters into a full-length
  vector and reduce-scatters it back.
"""

import numpy as np
import torch

from ..ops.sparse import CSROperator, _segment_sum
from .mesh import ROWS


def pad_unit_diagonal(A, pad):
    """Append ``pad`` unit-diagonal rows and columns to a scipy CSR matrix.

    No coupling to real rows: padded entries of every solver vector start
    at zero and stay exactly zero (identity rows map 0 to 0, padded columns
    are never read by real rows), so Krylov trajectories equal the unpadded
    problem's, and diagonal-dividing solvers and smoothers divide by 1 at
    padded rows instead of 0/0 = NaN."""
    import scipy.sparse

    if pad == 0:
        # a copy, so the sort never mutates the caller's matrix
        A = A.tocsr().copy()
        A.sort_indices()
        return A
    n0, m0 = A.shape
    A = A.copy()
    A.resize((n0 + pad, m0 + pad))
    eye_pad = scipy.sparse.csr_matrix(
        (np.ones(pad, A.dtype), (np.arange(n0, n0 + pad), np.arange(m0, m0 + pad))),
        shape=A.shape,
    )
    A = (A + eye_pad).tocsr()
    A.sort_indices()
    return A


def check_local_rows(what, n_local, A_op):
    """A preconditioner partition built for another slab size than the
    solve's operator refuses (``what`` names it)."""
    n_op = getattr(A_op, "n_local", None)
    if n_op is not None and int(n_op) != n_local:
        raise ValueError(
            f"{what} partition built for local rows {n_local} but the sharded operator "
            f"has n_local={int(n_op)}"
        )


def _scipy_csr(A):
    """A scipy CSR matrix of a scipy matrix, of the port's
    :class:`CSROperator` or of an operator with a scipy twin
    (``toscipy``)."""
    import scipy.sparse

    if isinstance(A, CSROperator):
        return scipy.sparse.csr_matrix(
            (A.data.cpu().numpy(), A.indices.cpu().numpy(), A.indptr.cpu().numpy()),
            shape=A.shape,
        )
    if hasattr(A, "toscipy"):
        return A.toscipy()
    return A.tocsr()


def partition_csr(A, n_shards):
    """Split a CSR matrix into ``n_shards`` contiguous row slabs (host side).

    ``A`` is a scipy sparse matrix or a :class:`CSROperator`.  Returns a
    dict of stacked numpy arrays (leading axis = shard) and the static
    geometry, as the reference's.  Padding entries (data 0) sit in the
    slab's last row, so each slab's rows stay sorted.
    """
    A = _scipy_csr(A)
    A.sort_indices()
    N = A.shape[0]
    pad = (-N) % n_shards
    if pad:
        A = pad_unit_diagonal(A, pad)
        N = N + pad
    n_local = N // n_shards

    datas, cols, rows = [], [], []
    h = 0  # halo width: the farthest any column lies outside its slab
    for s in range(n_shards):
        r0, r1 = s * n_local, (s + 1) * n_local
        blk = A[r0:r1].tocoo()
        datas.append(blk.data)
        cols.append(blk.col)
        rows.append(blk.row)
        if blk.nnz:
            h = max(h, int(max(r0 - blk.col.min(), blk.col.max() + 1 - r1, 0)))

    mode = "halo" if h <= n_local else "gather"
    nnz_max = max(len(d) for d in datas)

    data = np.zeros((n_shards, nnz_max), dtype=A.dtype)
    col = np.zeros((n_shards, nnz_max), dtype=np.int32)
    row = np.full((n_shards, nnz_max), n_local - 1, dtype=np.int32)
    for s in range(n_shards):
        k = len(datas[s])
        data[s, :k] = datas[s]
        row[s, :k] = rows[s]
        if mode == "halo":
            # extended-vector coordinates: global column c -> c - r0 + h
            col[s, :k] = cols[s] - s * n_local + h
            col[s, k:] = h  # padding reads a valid slot (its data is 0)
        else:
            col[s, :k] = cols[s]

    return {
        "data": data, "col": col, "row": row, "n_local": n_local, "halo": h,
        "mode": mode, "shape": A.shape,
    }


class ShardedCSROperator:
    """Local row slab of a CSR matrix.

    ``data``, ``col``, ``row``: the shard's padded COO arrays from
    :func:`partition_csr` (one shard's row of the stacked arrays), as
    tensors on the rank's device.
    """

    def __init__(self, data, col, row, n_local, halo, mode, mesh, axis=ROWS):
        self.n_local = int(n_local)
        self._halo = int(halo)
        self.mode = mode
        self.mesh = mesh
        self.axis = axis
        n_src = (self.n_local + 2 * self._halo if mode == "halo"
                 else self.n_local * mesh.shape[axis])
        row = row.long()
        counts = torch.bincount(row, minlength=self.n_local)
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=row.device),
                            torch.cumsum(counts, 0)])
        self._csr = CSROperator(data, col, indptr, (self.n_local, n_src), row_ids=row)

    @property
    def data(self):
        return self._csr.data

    @property
    def col(self):
        return self._csr.indices

    @property
    def row(self):
        return self._csr.row_ids

    @property
    def shape(self):
        return (self.n_local, self.n_local)

    @property
    def dtype(self):
        return self._csr.dtype

    @property
    def device(self):
        return self._csr.device

    def _x_ext(self, x):
        h = self._halo
        if h == 0:
            return x
        left, right = self.mesh.start_exchange(x[-h:], x[:h], self.axis).wait()
        return torch.cat([left, x, right], dim=0)

    def __matmul__(self, x):
        if self.mode == "halo":
            x_src = self._x_ext(x)
        else:
            x_src = self.mesh.all_gather_rows(x, self.axis)
        return self._csr @ x_src

    matvec = __matmul__

    def ensure_adjoint(self):
        """Build the local CSR's column-grouped adjoint now (once, outside
        any CUDA-graph capture)."""
        self._csr.ensure_adjoint()
        return self

    def rmatvec(self, x):
        y_src = self._csr.rmatvec(x)  # contributions to every column read
        if self.mode == "gather":
            # full-length scatter, then reduce-scatter back to the slabs
            return self.mesh.reduce_scatter_rows(y_src, self.axis)
        h = self._halo
        y = y_src[h : h + self.n_local]
        if h:
            # the left-halo contributions belong to the previous rank's last
            # rows, the right-halo ones to the next rank's first rows
            from_prev, from_next = self.mesh.start_exchange(
                y_src[-h:], y_src[:h], self.axis).wait()
            y = y.clone()
            y[:h] += from_prev
            y[-h:] += from_next
        return y

    def diagonal(self):
        if self.mode == "halo":
            diag_col = self.row + self._halo
        else:
            diag_col = self.row + self.mesh.coord[self.axis] * self.n_local
        on_diag = self.col == diag_col
        return _segment_sum(torch.where(on_diag, self.data, 0), self._csr.indptr)
