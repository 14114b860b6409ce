"""Incomplete-LU preconditioner on level-scheduled triangular sweeps.

Counterpart of ``krylov_tpu.ILUPreconditioner``: the ``Ml`` of
gmres/bicgstab/cgs/qmr.  For SPD matrices with symmetric sparsity,
``method="ilu0"`` (no pivoting, the exact pattern) factors into ``L D Lᵀ``
(the IC(0) equivalence), so it is also a valid SPD ``M`` of cg/minres;
``method="ilut"`` pivots and is for the nonsymmetric family only.

Set-up, once, on the host: ``method="ilu0"`` factors on the sparsity pattern
of ``A`` (the numerics in the native helper of :mod:`.ops._native`, the
numpy row pass as fallback and ground truth), so the factors' dependency
depth is the matrix wavefront (~2·sqrt(N) on 2-D grids);
``method="ilut"`` is ``scipy.sparse.linalg.spilu`` (SuperLU ILUTP).  The
factors' rows are grouped into dependency levels (``ops.triangular``).

Apply, on the factors' device: two :class:`StackedTriangularSweep` solves, a
level at a time (a gather, a product, a per-row sum and a scatter a level;
plain PyTorch: the reference has no kernel here), and for ILUT two
``index_select`` permutation gathers.  The semantics equal
``SuperLU.solve``: ``z[perm_r] = r;  y = L⁻¹ z;  w = U⁻¹ y;  M r =
w[perm_c]``.
"""

import numpy as np
import torch

from . import _device
from .ops._native import ilu0_factor_native
from .ops.triangular import StackedTriangularSweep, stacked_level_arrays

__all__ = ["ILUPreconditioner"]


def _sweep(factor, lower, max_levels, device):
    """One level-scheduled sweep of a scipy triangular factor, on ``device``."""
    arrs = stacked_level_arrays([factor], factor.shape[0], lower=lower, max_levels=max_levels)
    return StackedTriangularSweep(*(torch.from_numpy(a[0]).to(device) for a in arrs),
                                  factor.shape[0])


def _ilu0_numeric_numpy(A):
    """Numpy fallback and ground truth of the ILU(0) numeric phase (one
    Python pass over the rows; each row's update is a vectorized index
    intersection)."""
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = A.data.astype(np.result_type(A.dtype, np.float32)).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        dp = np.searchsorted(cols, i)
        if dp < e - s and cols[dp] == i:
            diag_pos[i] = s + dp

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        for t in range(s, e):
            k = indices[t]
            if k >= i:
                break
            dk = diag_pos[k]
            ukk = data[dk] if dk >= 0 else 0.0
            if ukk == 0:
                ukk = 1.0  # breakdown guard
            lik = data[t] / ukk
            data[t] = lik
            # row i -= lik * (upper part of row k), restricted to row i's
            # own pattern (that restriction is the "(0)" in ILU(0))
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks <= 0 or ks >= ke:
                continue
            kcols = indices[ks:ke]
            pos = np.searchsorted(cols, kcols)
            ok = (pos < cols.shape[0]) & (cols[np.minimum(pos, cols.shape[0] - 1)] == kcols)
            data[s + pos[ok]] -= lik * data[ks:ke][ok]
    return data


def _ilu0_factor(A):
    """ILU(0): incomplete LU on the exact sparsity pattern of ``A``, no
    pivoting (IKJ order).  Returns scipy ``(L, U)`` with the unit lower
    diagonal stored explicitly."""
    import scipy.sparse

    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = ilu0_factor_native(A)
    if data is not None:
        data = data.astype(np.result_type(A.dtype, np.float32))
    else:
        data = _ilu0_numeric_numpy(A)

    row_of = np.repeat(np.arange(n), np.diff(indptr))
    low = indices < row_of
    upp = ~low
    L = scipy.sparse.csr_matrix(
        (np.concatenate([data[low], np.ones(n, data.dtype)]),
         (np.concatenate([row_of[low], np.arange(n)]),
          np.concatenate([indices[low], np.arange(n)]))),
        shape=A.shape,
    )
    U = scipy.sparse.csr_matrix((data[upp], (row_of[upp], indices[upp])), shape=A.shape)
    # rows with a missing or zeroed diagonal solve against 1 (the guard of
    # the stationary sweeps)
    du = U.diagonal()
    if np.any(du == 0):
        U = U + scipy.sparse.diags((du == 0).astype(U.dtype))
    return L.tocsr(), U.tocsr()


def _gather(perm, device):
    return None if perm is None else torch.from_numpy(np.asarray(perm, np.int64)).to(device)


class ILUPreconditioner:
    """``z = M @ r`` applies one ILU solve (``M r ~= A^{-1} r``).

    Build with :meth:`from_scipy`.  ``rmatvec`` (qmr's left preconditioner
    needs it) is there when built with ``with_rmatvec=True``.
    """

    def __init__(self, lsolve, usolve, ipr, pc, adj=None):
        self._l = lsolve
        self._u = usolve
        self._ipr = ipr  # inverse row permutation (gather indices) or None
        self._pc = pc  # column permutation (gather indices) or None
        self._adj = adj  # (uH lower solve, lH upper solve, ipc, pr) or None

    @classmethod
    def from_scipy(cls, A, *, method="ilu0", drop_tol=1e-4, fill_factor=10, max_levels=4096,
                   with_rmatvec=False, dtype=None, device=None, **spilu_kwargs):
        """``method="ilu0"`` (default): exact-pattern no-pivot factors, whose
        level chains are as shallow as the matrix wavefront.
        ``method="ilut"``: SuperLU ILUTP; ``drop_tol`` and ``fill_factor``
        are its knobs (smaller ``drop_tol`` or larger ``fill_factor``:
        stronger, denser, deeper factors).  ``dtype`` (numpy) casts the
        factors; ``max_levels`` bounds their dependency-level count.  The
        factors go to ``device`` (the default device when None)."""
        import scipy.sparse

        device = _device.resolve(device)
        if not scipy.sparse.issparse(A):
            A = scipy.sparse.csr_matrix(np.asarray(A))
        if method == "ilu0":
            L, U = _ilu0_factor(A)
            perm_r = perm_c = None
        elif method == "ilut":
            from scipy.sparse.linalg import spilu

            ilu = spilu(A.tocsc(), drop_tol=drop_tol, fill_factor=fill_factor, **spilu_kwargs)
            L, U = ilu.L.tocsr(), ilu.U.tocsr()
            perm_r, perm_c = ilu.perm_r, ilu.perm_c
        else:
            raise ValueError(f"unknown method {method!r}")
        if dtype is not None:
            L, U = L.astype(dtype), U.astype(dtype)
        lsolve = _sweep(L, True, max_levels, device)
        usolve = _sweep(U, False, max_levels, device)
        adj = None
        if with_rmatvec:
            # ilu0 has identity permutations: None, so an application
            # skips the gathers
            adj = (
                _sweep(U.conj().T.tocsr(), True, max_levels, device),
                _sweep(L.conj().T.tocsr(), False, max_levels, device),
                _gather(None if perm_c is None else np.argsort(perm_c), device),
                _gather(perm_r, device),
            )
        return cls(lsolve, usolve,
                   _gather(None if perm_r is None else np.argsort(perm_r), device),
                   _gather(perm_c, device), adj=adj)

    @property
    def shape(self):
        return (self._l.n_local, self._l.n_local)

    @property
    def dtype(self):
        return self._l.dat.dtype

    @property
    def device(self):
        return self._l.dat.device

    @property
    def nlevels(self):
        """Dependency-level counts of the (L, U) sweeps."""
        return (self._l.nlevels, self._u.nlevels)

    def __matmul__(self, r):
        z = r if self._ipr is None else r.index_select(0, self._ipr)  # z[perm_r] = r
        w = self._u(self._l(z))
        return w if self._pc is None else w.index_select(0, self._pc)

    matvec = __matmul__

    def rmatvec(self, r):
        if self._adj is None:
            raise ValueError(
                "build ILUPreconditioner.from_scipy(..., with_rmatvec=True) "
                "for solvers that apply the adjoint preconditioner (qmr)"
            )
        uH, lH, ipc, pr = self._adj
        w = lH(uH(r if ipc is None else r.index_select(0, ipc)))
        return w if pr is None else w.index_select(0, pr)
