"""Row-partitioned BSR operator (all-gather mode).

Counterpart of ``krylov_tpu.parallel.bsr``.  Each rank owns a slab of block
rows and runs K12 (:func:`krylov_tpu_torch.ops.cuda_bsr.bsr_spmm`, through
:class:`~krylov_tpu_torch.ops.bsr.BSROperator`) on it against the
all-gathered iterate: dense block columns reach far from the diagonal, so
the all-gather mirrors the CSR ``"gather"`` strategy.  The adjoint computes
the slab's full-length contribution and reduce-scatters it back.
"""

import torch

from ..ops.bsr import BSROperator
from .mesh import ROWS


class ShardedBSROperator:
    """Local block-row slab of a :class:`BSROperator`.

    ``data (nbrows_local * max_blocks, R, C)``; ``cols (nbrows_local,
    max_blocks)`` hold GLOBAL block-column indices.  ``n_global`` is the
    full matrix dimension.
    """

    def __init__(self, data, cols, n_global, mesh, axis=ROWS):
        self.n_global = int(n_global)
        self.mesh = mesh
        self.axis = axis
        self._local = BSROperator(data, cols, (cols.shape[0] * data.shape[1], n_global))

    @property
    def dtype(self):
        return self._local.dtype

    @property
    def device(self):
        return self._local.device

    @property
    def blocksize(self):
        return self._local.blocksize

    @property
    def shape(self):
        n_local = self._local.shape[0]
        return (n_local, n_local)  # the local SPMD view

    def __matmul__(self, x):
        return self._local @ self.mesh.all_gather_rows(x, self.axis)

    matvec = __matmul__

    def ensure_adjoint(self):
        """Build the local slab's block transpose now (once, outside any
        CUDA-graph capture)."""
        self._local.ensure_adjoint()
        return self

    def rmatvec(self, x):
        return self.mesh.reduce_scatter_rows(self._local.rmatvec(x), self.axis)

    def diagonal(self):
        R, C = self.blocksize
        nbrows, max_blocks = self._local.cols.shape
        if R != C:
            return torch.zeros(self._local.shape[0], dtype=self.dtype, device=self.device)
        b0 = self.mesh.coord[self.axis] * nbrows
        brow = (torch.arange(nbrows, device=self.device) + b0).repeat_interleave(max_blocks)
        on_diag = self._local.cols.reshape(-1).long() == brow
        blk_diags = torch.diagonal(self._local.data, dim1=1, dim2=2)
        contrib = torch.where(on_diag[:, None], blk_diags, 0)
        return contrib.reshape(nbrows, max_blocks, R).sum(dim=1).reshape(-1)
