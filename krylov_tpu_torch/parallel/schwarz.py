"""Additive-Schwarz ILU(0): each rank factors its own diagonal block.

Counterpart of ``krylov_tpu.parallel.schwarz`` (PETSc's ``bjacobi + ilu0``):
each slab's diagonal block gets an exact-pattern ILU(0) factorization on the
host, couplings to other slabs are dropped (the additive-Schwarz
approximation), and an application is two triangular sweeps on the rank's
own rows, with no communication.  Nonsymmetric, so it is the ``Ml`` of
gmres, bicgstab, cgs and qmr (``sharded_solve`` routes ``M_partition``
there for the solvers without ``M``).

The sweeps are the port's :class:`~krylov_tpu_torch.ops.triangular.StackedTriangularSweep`
over dependency levels padded to one shape (:func:`stacked_level_arrays`):
per level a gather, a product and a segment sum in stored order, so an
application repeats bit for bit.  The partition holds numpy arrays only, so
it pickles to the ranks; each rank moves its own slab to its device.
"""

import numpy as np
import torch

from .. import _device
from ..ilu import _ilu0_factor
from ..ops.triangular import StackedTriangularSweep, stacked_level_arrays
from .csr import check_local_rows, pad_unit_diagonal
from .mesh import ROWS

__all__ = ["ILUSchwarzPartition", "partition_ilu0"]


class _LocalILUSchwarz:
    """``z = U^-1 L^-1 r`` on one slab's own diagonal block."""

    def __init__(self, lsweep, usweep, adj=None):
        self._l = lsweep
        self._u = usweep
        self._adj = adj  # (U^H lower sweep, L^H upper sweep) | None

    @property
    def shape(self):
        n = self._l.n_local
        return (n, n)

    @property
    def dtype(self):
        return self._l.dat.dtype

    def __matmul__(self, r):
        return self._u(self._l(r))

    matvec = __matmul__

    def rmatvec(self, r):
        if self._adj is None:
            raise ValueError(
                "build partition_ilu0(..., with_rmatvec=True) for solvers that apply "
                "the adjoint preconditioner (qmr)"
            )
        uH, lH = self._adj
        return lH(uH(r))


class ILUSchwarzPartition:
    """Sharded block-Jacobi ILU(0) for ``sharded_solve(M_partition=)``.

    ``arrays``: 10 (or 20 with the adjoint) stacked ``(S, nlev, .)`` numpy
    arrays of :func:`stacked_level_arrays`, in the order L, U (, U^H, L^H),
    five a factor."""

    def __init__(self, arrays, n_shards, shape, n_pad, with_rmatvec):
        self._arrays = arrays
        self.n_shards = int(n_shards)
        self.shape = tuple(shape)
        self.n_pad = int(n_pad)
        self._with_rmatvec = bool(with_rmatvec)

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def nlevels(self):
        """(L, U) padded dependency-level counts (the largest of the slabs)."""
        return (self._arrays[0].shape[1], self._arrays[5].shape[1])

    def _sweeps(self, s, device):
        """Slab ``s``'s sweeps on ``device``."""
        t = [torch.from_numpy(np.ascontiguousarray(a[s])).to(device) for a in self._arrays]
        n = self.n_local_fine
        adj = None
        if self._with_rmatvec:
            adj = (StackedTriangularSweep(*t[10:15], n), StackedTriangularSweep(*t[15:20], n))
        return _LocalILUSchwarz(StackedTriangularSweep(*t[0:5], n),
                                StackedTriangularSweep(*t[5:10], n), adj=adj)

    def make_local(self, A_op, mesh):
        """This rank's sweeps on ``mesh.device`` (see the protocol in
        :mod:`krylov_tpu_torch.parallel.solve`)."""
        check_local_rows("ILU-Schwarz", self.n_local_fine, A_op)
        return self._sweeps(mesh.coord[ROWS], mesh.device)

    def as_global(self, device=None):
        """The single-device twin on the padded problem: the same per-slab
        sweeps, one slab after another (the apply is slab-local, so the twin
        is exact)."""
        return _GlobalILUSchwarz(self, _device.resolve(device))


class _GlobalILUSchwarz:
    def __init__(self, part, device):
        self._part = part
        self._slabs = [part._sweeps(s, device) for s in range(part.n_shards)]

    @property
    def shape(self):
        return (self._part.n_pad, self._part.n_pad)

    @property
    def dtype(self):
        return self._slabs[0].dtype

    def _apply(self, r, adjoint):
        n = self._part.n_local_fine
        return torch.cat([
            slab.rmatvec(r[s * n : (s + 1) * n]) if adjoint else slab @ r[s * n : (s + 1) * n]
            for s, slab in enumerate(self._slabs)
        ])

    def __matmul__(self, r):
        return self._apply(r, adjoint=False)

    matvec = __matmul__

    def rmatvec(self, r):
        return self._apply(r, adjoint=True)


def partition_ilu0(A, n_shards, *, with_rmatvec=False, dtype=None, max_levels=4096):
    """Host set-up of sharded ILU(0)-Schwarz (the ``M_partition`` protocol).

    Factors each slab's diagonal block on its exact pattern, no pivoting
    (:func:`~krylov_tpu_torch.ilu._ilu0_factor`).  The matrix is padded with
    unit-diagonal rows to the shard multiple, as
    :func:`~krylov_tpu_torch.parallel.csr.partition_csr` pads the solve's, so
    pass the SAME matrix to both.  ``with_rmatvec`` also stacks the adjoint's
    sweeps (qmr applies it)."""
    import scipy.sparse

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    if A.shape[0] != A.shape[1]:
        raise ValueError("ILU-Schwarz needs a square matrix")
    N = A.shape[0]
    A_pad = pad_unit_diagonal(A.tocsr(), (-N) % n_shards)
    n_pad = A_pad.shape[0]
    n_local = n_pad // n_shards
    dt = dtype or A_pad.dtype

    Ls, Us, UHs, LHs = [], [], [], []
    for s in range(n_shards):
        r0 = s * n_local
        L, U = _ilu0_factor(A_pad[r0 : r0 + n_local, r0 : r0 + n_local].tocsr())
        if dtype is not None:
            L, U = L.astype(dtype), U.astype(dtype)
        Ls.append(L)
        Us.append(U)
        if with_rmatvec:
            UHs.append(U.conj().T.tocsr())
            LHs.append(L.conj().T.tocsr())

    arrays = list(stacked_level_arrays(Ls, n_local, True, max_levels, dt))
    arrays += list(stacked_level_arrays(Us, n_local, False, max_levels, dt))
    if with_rmatvec:
        arrays += list(stacked_level_arrays(UHs, n_local, True, max_levels, dt))
        arrays += list(stacked_level_arrays(LHs, n_local, False, max_levels, dt))
    return ILUSchwarzPartition(arrays, n_shards, A.shape, n_pad, with_rmatvec)
