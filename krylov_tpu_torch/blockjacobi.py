"""Block-Jacobi preconditioner: batched dense inverses of the diagonal blocks.

Counterpart of ``krylov_tpu.BlockJacobiPreconditioner`` (single device; the
sharded partition comes with distribution).  Non-overlapping additive
Schwarz with exact block solves: for SPD ``A`` every diagonal block is SPD,
so the preconditioner is SPD and a valid ``M`` of cg/minres.  Line-shaped
blocks (``block = ny`` on an ``nx x ny`` grid) give line Jacobi, which
pointwise Jacobi cannot imitate on anisotropic problems.

Set-up, on the host (numpy, as the reference): the block diagonal in one COO
filter, inverted in one batched ``np.linalg.inv``.  Apply, on the inverses'
device: one batched product ``z_b = inv_b r_b`` (``torch.einsum``, a batched
matmul; the reference computes it as a plain einsum too, outside any Pallas
kernel), with the ragged tail zero-padded and sliced off.
"""

import numpy as np
import torch

from . import _device

__all__ = ["BlockJacobiPreconditioner"]


def _block_diag_inverses(A, block, dtype=None):
    """``(nb, k, k)`` batched inverses of the diagonal blocks of ``A``
    (zero-padded to the block multiple; padded and empty diagonal entries
    are set to 1 so the padding acts as the identity), and ``n``."""
    import scipy.sparse

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    if A.shape[0] != A.shape[1]:
        raise ValueError("block Jacobi needs a square matrix")
    k = int(block)
    if k <= 0:
        raise ValueError("block must be positive")
    n = A.shape[0]
    nb = -(-n // k)
    coo = A.tocoo()
    keep = (coo.row // k) == (coo.col // k)
    blocks = np.zeros((nb, k, k), dtype=dtype or A.dtype)
    np.add.at(
        blocks,
        (coo.row[keep] // k, coo.row[keep] % k, coo.col[keep] % k),
        coo.data[keep],
    )
    d = np.einsum("bii->bi", blocks)  # writable diagonal view
    d[d == 0] = 1.0
    return np.linalg.inv(blocks), n


def _apply_blocks(inv, r):
    """``z_b = inv_b r_b`` for every block in one batched product; ``r`` is
    ``(n,)`` or ``(n, k)``, zero-padded to the block grid and sliced back."""
    nb, k, _ = inv.shape
    tail = tuple(r.shape[1:])
    dt = torch.promote_types(inv.dtype, r.dtype)
    pad = nb * k - r.shape[0]
    rp = torch.cat([r, r.new_zeros((pad,) + tail)]) if pad else r
    z = torch.einsum("bij,bj...->bi...", inv.to(dt), rp.to(dt).reshape((nb, k) + tail))
    return z.reshape((nb * k,) + tail)[: r.shape[0]]


class BlockJacobiPreconditioner:
    """``z = M @ r`` solves each diagonal block exactly (one batched
    product).  Build with :meth:`from_scipy`; SPD for SPD input, so it is a
    valid ``M`` of cg/minres in either backend."""

    hermitian = True

    def __init__(self, inv, n):
        self._inv = inv
        self._n = int(n)

    @classmethod
    def from_scipy(cls, A, block=64, dtype=None, device=None):
        """``block``: the uniform block size ``k``; rows are grouped
        contiguously and the trailing block is zero-padded.  On a grid,
        ``block = ny`` gives line Jacobi.  ``dtype`` (numpy) casts the
        blocks; the inverses go to ``device`` (the default device when
        None)."""
        inv, n = _block_diag_inverses(A, block, dtype=dtype)
        return cls(torch.from_numpy(inv).to(_device.resolve(device)), n)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._inv.dtype

    @property
    def device(self):
        return self._inv.device

    @property
    def block(self):
        return self._inv.shape[1]

    def __matmul__(self, r):
        return _apply_blocks(self._inv, r)

    matvec = __matmul__

    def rmatvec(self, r):
        return _apply_blocks(self._inv.conj().transpose(1, 2), r)
