"""Block-sparse-row (BSR) operator (counterpart of ``krylov_tpu.ops.bsr``).

BSR in ELL-padded form: every block row stores the same number of blocks,
zero blocks (pointing at block column 0) pad short rows and contribute
exact zeros.  The multi-RHS matvec is kernel K12
(:func:`krylov_tpu_torch.ops.cuda_bsr.bsr_spmm`) on a CUDA device, for every
``R``, ``C`` and ``k``, and its plain einsum on the CPU; the adjoint is K12
again, on the block transpose (:class:`~krylov_tpu_torch.ops.cuda_bsr.
BsrTranspose`).
"""

import numpy as np
import torch

from .. import _device
from . import cuda_bsr


class BSROperator:
    """ELL-padded BSR: ``data (nbrows * max_blocks, R, C)``,
    ``cols (nbrows, max_blocks)`` int32 block-column indices."""

    def __init__(self, data, cols, shape):
        self.data = data
        self.cols = cols
        self.shape = tuple(int(s) for s in shape)
        self._adjoint = None  # the block transpose, once built

    @classmethod
    def from_scipy(cls, A, blocksize=None, device=None):
        """Convert a scipy sparse matrix (any format) to ELL-padded BSR."""
        device = _device.resolve(device)
        bsr = A.tobsr(blocksize=blocksize) if blocksize is not None else A.tobsr()
        bsr.sort_indices()
        R, C = bsr.blocksize
        nbrows = bsr.shape[0] // R
        counts = np.diff(bsr.indptr)
        max_blocks = max(1, int(counts.max()))

        data = np.zeros((nbrows * max_blocks, R, C), dtype=bsr.dtype)
        cols = np.zeros((nbrows, max_blocks), dtype=np.int32)
        # slot of each stored block inside its padded row
        rows = np.repeat(np.arange(nbrows), counts)
        slot = np.arange(bsr.indices.size) - np.repeat(bsr.indptr[:-1], counts)
        data[rows * max_blocks + slot] = bsr.data
        cols[rows, slot] = bsr.indices
        return cls(torch.from_numpy(data).to(device), torch.from_numpy(cols).to(device),
                   bsr.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def blocksize(self):
        return tuple(self.data.shape[1:])

    @property
    def nnz(self):
        """Stored entries (including ELL and in-block zero padding)."""
        return int(np.prod(self.data.shape))

    def _spmm(self, x2):
        return cuda_bsr.bsr_spmm(self.data, self.cols, x2)

    def __matmul__(self, x):
        if x.ndim not in (1, 2) or x.shape[0] != self.shape[1]:
            raise ValueError(f"x of shape {tuple(x.shape)} does not match the operator's "
                             f"{self.shape}")
        if x.ndim == 1:
            return self._spmm(x[:, None])[:, 0]
        return self._spmm(x)

    matvec = __matmul__

    def _transpose(self):
        return cuda_bsr.BsrTranspose(self.data, self.cols, self.shape[1] // self.blocksize[1])

    def ensure_adjoint(self):
        """Build the block transpose of ``A^H`` now (once; it reads the
        device, so outside any CUDA-graph capture) and keep it on the
        operator for :meth:`rmatvec`."""
        if self._adjoint is None:
            with torch.no_grad():
                self._adjoint = self._transpose()
        return self

    def rmatvec(self, x):
        """``A^H x`` through the block transpose :meth:`ensure_adjoint`
        keeps, in one fixed order on every device: K12 on the transpose as
        ELL-padded BSR, at most twice the blocks the operator stores; where
        a dense block column would pad it past that, a column-sorted
        segment sum of the block products (``cuda_bsr.ADJOINT_PATHS``
        counts the routes; the transpose's ``route`` says which a matrix
        takes).  Where autograd tracks ``data``, a transpose is built for
        the call, so the product stays differentiable."""
        if x.ndim not in (1, 2) or x.shape[0] != self.shape[0]:
            raise ValueError(f"x of shape {tuple(x.shape)} does not match the adjoint of the "
                             f"operator's {self.shape}")
        adj = (self._transpose() if torch.is_grad_enabled() and self.data.requires_grad
               else self.ensure_adjoint()._adjoint)
        if x.ndim == 1:
            return adj(x[:, None])[:, 0]
        return adj(x)

    def diagonal(self):
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        if R != C:
            return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        brow = torch.arange(nbrows, device=self.device).repeat_interleave(max_blocks)
        on_diag = self.cols.reshape(-1).long() == brow
        blk_diags = torch.diagonal(self.data, dim1=1, dim2=2)  # (nb_total, R)
        contrib = torch.where(on_diag[:, None], blk_diags, 0)
        return contrib.reshape(nbrows, max_blocks, R).sum(dim=1).reshape(-1)

    def todense(self):
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        nbcols = self.shape[1] // C
        out = torch.zeros((nbrows, nbcols, R, C), dtype=self.dtype, device=self.device)
        brow = torch.arange(nbrows, device=self.device).repeat_interleave(max_blocks)
        out.index_put_((brow, self.cols.reshape(-1).long()), self.data, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(self.shape)

    def tree_flatten(self):
        return (self.data, self.cols), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        return cls(*children, shape)


def detect_blocksize(
    sp,
    candidates=((128, 128), (64, 64), (32, 32)),
    min_fill=0.35,
    min_nnz=1 << 15,
):
    """Whether a scipy sparse matrix is profitably block-structured (host
    scipy, the reference's rule).

    Among the candidate blocksizes whose dense-block fill (true nnz over
    stored block entries) reaches ``min_fill``, returns the one with the
    highest fill; ``None`` when none qualifies.  A candidate whose ELL
    padding would store more than ``nnz / min_fill`` entries is rejected
    (a skewed matrix, such as an arrow, passes the fill test but would
    allocate near-dense memory).
    """
    import scipy.sparse

    n, m = sp.shape
    if sp.nnz < min_nnz:
        return None
    max_ell_expand = 1.0 / min_fill
    coo = sp.tocoo()
    best, best_fill = None, min_fill
    for R, C in candidates:
        if n % R or m % C:
            continue
        coarse = scipy.sparse.csr_matrix(
            (np.ones(sp.nnz, np.int64), (coo.row // R, coo.col // C)),
            shape=(n // R, m // C),
        )
        nblocks = coarse.count_nonzero()
        fill = sp.nnz / (nblocks * R * C) if nblocks else 0.0
        counts = np.diff(coarse.indptr)
        ell_entries = (n // R) * int(counts.max() if counts.size else 0) * R * C
        if ell_entries > max_ell_expand * sp.nnz:
            continue
        if fill >= best_fill:
            best, best_fill = (R, C), fill
    return best
