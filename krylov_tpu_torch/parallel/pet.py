"""Row-partitioned PET operator: general sparsity on the CSR kernels.

Counterpart of ``krylov_tpu.parallel.pet``.  Each rank owns a contiguous row
slab of the matrix; the iterate is all-gathered and the slab's product runs
K10 (:func:`krylov_tpu_torch.ops.cuda_spmv.csr_matvec`) for one right-hand
side and K11 (:func:`~krylov_tpu_torch.ops.cuda_spmv.csr_matmat`) for a
block, ``n_local`` output rows read against a global-length ``x``.  The
adjoint runs K10 on the conjugate transpose of the rank's COLUMN slab,
whose rows are exactly the rank's own (no reduction needed).

The reference builds each shard's page-ELL PET chunks on the host; the port
keeps its partition contract (an all-gathered ``x``, local rows, a ``t_``
adjoint of the column slab, unit-diagonal padding, ``reorder=``, bfloat16
``data_dtype``) on the port's plain CSR, as :class:`PETOperator` does.
Values are float32 or bfloat16, products and sums float32.
"""

import torch

from ..ops.cuda_spmv import _CSR, _value_dtype, resolve_reorder
from .csr import pad_unit_diagonal
from .mesh import ROWS


class PETPartition(dict):
    """A host-side PET partition (the marker type ``sharded_solve`` takes).

    Keys: ``rows`` and ``t_rows`` (per shard, the scipy CSR row slab and
    the conjugate transpose of the column slab), ``n_local``, ``shape``
    (padded), ``perm`` (the symmetric reordering, or None),
    ``data_dtype`` and ``fill`` (1.0: CSR streams no padding).
    """


def partition_pet(sp, n_shards, data_dtype=None, reorder=None):
    """Host-side partition of a scipy sparse matrix into per-shard CSR slabs.

    ``reorder``: ``"rcm"`` partitions the symmetric reverse-Cuthill-McKee
    reordering of the matrix, ``"auto"`` reorders when the reference's
    sampled fill says it pays, an index array uses that permutation.
    ``sharded_solve`` permutes the vectors once a solve and returns the
    iterate in user order.  A row count that does not divide into the
    shards is padded with unit-diagonal rows; ``sharded_solve`` pads the
    vectors and slices the solution back.
    """
    import scipy.sparse

    sp = scipy.sparse.csr_matrix(sp)
    perm = resolve_reorder(sp, reorder, metric="fill")
    if perm is not None:
        sp = sp[perm][:, perm].tocsr()
    n = sp.shape[0]
    sp = pad_unit_diagonal(sp, (-n) % n_shards)
    n_local = sp.shape[0] // n_shards
    sp_t = sp.T.conj().tocsr()
    return PETPartition(
        rows=[sp[i * n_local : (i + 1) * n_local] for i in range(n_shards)],
        t_rows=[sp_t[i * n_local : (i + 1) * n_local] for i in range(n_shards)],
        n_local=n_local, shape=sp.shape, perm=perm,
        data_dtype=_value_dtype(data_dtype), fill=1.0,
    )


class ShardedPETOperator:
    """Local row slab of a PET partition, ``x`` all-gathered.

    ``rows``, ``t_rows``: this rank's scipy row slab and the conjugate
    transpose of its column slab; both go to ``mesh.device`` once, in the
    value dtype ``data_dtype`` (float32 or bfloat16).
    """

    def __init__(self, rows, t_rows, n_global, mesh, data_dtype=None, axis=ROWS):
        value_dtype = _value_dtype(data_dtype)
        self._csr = _CSR(rows, value_dtype, mesh.device)
        self._csr_t = _CSR(t_rows, value_dtype, mesh.device)
        self._value_dtype = value_dtype
        self.n_local = rows.shape[0]
        self.n_global = int(n_global)
        self.mesh = mesh
        self.axis = axis

    @property
    def dtype(self):
        return self._value_dtype

    @property
    def device(self):
        return self.mesh.device

    @property
    def shape(self):
        return (self.n_local, self.n_local)  # the local SPMD view

    def _cols(self, csr, x):
        x = self.mesh.all_gather_rows(x.to(torch.float32), self.axis)
        return csr.apply(x.contiguous())

    def __matmul__(self, x):
        return self._cols(self._csr, x)

    matvec = __matmul__

    def rmatvec(self, x):
        # the adjoint's row slab is the column slab of A: its CSR maps the
        # full x to exactly the owned rows
        return self._cols(self._csr_t, x)
