"""Block-Jacobi preconditioner: batched dense inverses of the diagonal blocks.

Counterpart of ``krylov_tpu.BlockJacobiPreconditioner`` and of its sharded
partition (:func:`partition_block_jacobi`, the ``M_partition`` of
:func:`krylov_tpu_torch.parallel.sharded_solve`).  Non-overlapping additive
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

__all__ = ["BlockJacobiPartition", "BlockJacobiPreconditioner", "partition_block_jacobi"]


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


class _LocalBlockJacobi:
    """A rank's slab of the block-Jacobi apply: its own blocks, no
    communication (blocks never cross a slab's edge)."""

    hermitian = True

    def __init__(self, inv):
        self._inv = inv

    @property
    def shape(self):
        n = self._inv.shape[0] * self._inv.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self._inv.dtype

    @property
    def device(self):
        return self._inv.device

    def __matmul__(self, r):
        return _apply_blocks(self._inv, r)

    matvec = __matmul__

    def rmatvec(self, r):
        return _apply_blocks(self._inv.conj().transpose(1, 2), r)


class BlockJacobiPartition:
    """Sharded block Jacobi for ``sharded_solve(M_partition=)``.

    Host state only (``(S, nb_local, k, k)`` numpy inverses), so it pickles
    to the ranks.  Blocks never cross a slab's edge, so the sharded apply
    needs no communication; ``block`` must divide the slab's row count."""

    def __init__(self, inv_stacked, n_shards, n, n_pad):
        self._inv = inv_stacked
        self.n_shards = int(n_shards)
        self.shape = (int(n), int(n))
        self.n_pad = int(n_pad)

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def block(self):
        return self._inv.shape[2]

    def make_local(self, A_op, mesh):
        """This rank's apply on ``mesh.device`` (see the protocol in
        :mod:`krylov_tpu_torch.parallel.solve`)."""
        from .parallel.csr import check_local_rows
        from .parallel.mesh import ROWS

        check_local_rows("block-Jacobi", self.n_local_fine, A_op)
        inv = self._inv[mesh.coord[ROWS]]
        return _LocalBlockJacobi(torch.from_numpy(np.ascontiguousarray(inv)).to(mesh.device))

    def as_global(self, device=None):
        """The single-device twin on the padded problem (the same blocks)."""
        S, nbl, k, _ = self._inv.shape
        return BlockJacobiPreconditioner(
            torch.from_numpy(self._inv.reshape(S * nbl, k, k)).to(_device.resolve(device)),
            self.n_pad)


def partition_block_jacobi(A, n_shards, block=64, dtype=None):
    """Host set-up of sharded block Jacobi (the ``M_partition`` protocol).

    The matrix is padded with unit-diagonal rows to the shard multiple, as
    :func:`~krylov_tpu_torch.parallel.csr.partition_csr` pads the solve's
    (identity blocks there), so pass the SAME matrix to both.  ``block``
    must divide the slab's row count."""
    import scipy.sparse

    from .parallel.csr import pad_unit_diagonal

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    N = A.shape[0]
    A_pad = pad_unit_diagonal(A.tocsr(), (-N) % n_shards)
    n_pad = A_pad.shape[0]
    n_local = n_pad // n_shards
    k = int(block)
    if n_local % k:
        raise ValueError(
            f"block={k} does not divide the shard-local row count {n_local} (padded "
            f"N={n_pad} over {n_shards} shards); pick a divisor of {n_local}"
        )
    inv, _ = _block_diag_inverses(A_pad, k, dtype=dtype)
    return BlockJacobiPartition(inv.reshape(n_shards, n_local // k, k, k), n_shards, N, n_pad)
