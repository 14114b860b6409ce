"""Distributed algebraic multigrid over the rows axis of a mesh.

Counterpart of ``krylov_tpu.parallel.amg``: the general-sparsity twin of
:class:`~krylov_tpu_torch.multigrid.ShardedGalerkinMultigrid`, which
coarsens the matrix instead of a grid stencil.

* **Set-up** (once, on the host, numpy and scipy): the smoothed-aggregation
  coarsening of :class:`~krylov_tpu_torch.amg.AMGPreconditioner`, built on
  the fine matrix padded with unit-diagonal rows to the shard multiple, so
  the hierarchy's row blocks are the solve's row slabs.  Each sharded level
  keeps its slabs of the level matrix (:func:`partition_csr`) and of the
  explicit smoothed prolongator (padded triplets).  The partition holds host
  state only and pickles to the ranks.
* **Apply** (every iteration, on the rank's device): the fine level smooths
  through the solve's own slab operator (:class:`ShardedCSROperator`, or
  :class:`ShardedPETOperator` on K10); deeper sharded levels through their
  own :class:`ShardedCSROperator`.  Aggregates cross slab edges, so grid
  transfer is a slab-local product followed by one collective: the
  restriction ``P_s^H d`` runs on the explicit conjugate transpose and the
  prolongation ``P_s e`` on the slab (K10, K11 for a blocked right-hand
  side, where the routing of ``as_operator`` sends the slab to
  :class:`~krylov_tpu_torch.ops.cuda_spmv.PETOperator`; else the port's
  CSR product): no float scatter-add, so an application repeats bit for
  bit.  The partial restriction is summed by ``all_reduce`` when the next
  level is the replicated tail, by ``reduce_scatter_rows`` when it is
  sharded (with ``all_gather_rows`` on the way back up); on a rank alone on
  its axis the mesh launches none of them.
* **Replicated tail**: after ``n_sharded_levels`` coarsenings every rank
  runs the same single-device ``AMGPreconditioner`` V-cycle (K10/K11) on
  the ~4^levels smaller problem.

``AMGPartition.as_global()`` is the same cycle with no collective: a
single-device twin on the padded problem, which pins the distributed
cycle's trajectory in tests.
"""

import numpy as np
import torch

from .. import _device
from ..amg import AMGPreconditioner, _coarsen, _device_sparse, _lmax_dinv_a, _smoothed_prolongator
from ..ops.sparse import CSROperator
from .csr import ShardedCSROperator, _scipy_csr, check_local_rows, pad_unit_diagonal, partition_csr
from .mesh import ROWS

__all__ = ["AMGPartition", "partition_amg"]


def _split_prolongator(Ps, n_shards):
    """Split the prolongator's rows into slabs of padded COO triplets.

    Returns stacked ``(dat, rowf, colc)`` of shape ``(S, nnz_max)``: ``rowf``
    the slab-local fine row, ``colc`` the global coarse column; the padding
    carries zero data at (row 0, column 0)."""
    n_loc = Ps.shape[0] // n_shards
    blks = [Ps[s * n_loc : (s + 1) * n_loc].tocoo() for s in range(n_shards)]
    nnz_max = max(max(b.nnz for b in blks), 1)
    dat = np.zeros((n_shards, nnz_max), dtype=Ps.dtype)
    rowf = np.zeros((n_shards, nnz_max), dtype=np.int32)
    colc = np.zeros((n_shards, nnz_max), dtype=np.int32)
    for s, b in enumerate(blks):
        dat[s, : b.nnz] = b.data
        rowf[s, : b.nnz] = b.row
        colc[s, : b.nnz] = b.col
    return dat, rowf, colc


def _triplets_csr(dat, rowf, colc, shape):
    """The scipy CSR of padded triplets (the padding sums in as zeros)."""
    import scipy.sparse

    return scipy.sparse.csr_matrix((dat, (rowf, colc)), shape=shape)


class _Transfer:
    """A prolongator slab ``P_s`` and its explicit conjugate transpose on a
    device: ``prolong(e) = P_s e``, ``restrict(d) = P_s^H d``."""

    def __init__(self, P, device):
        self._p = _device_sparse(P, device)  # PETOperator holds its adjoint's CSR
        self._ph = self._p.adjoint() if isinstance(self._p, CSROperator) else None

    def prolong(self, e):
        return self._p @ e

    def restrict(self, d):
        return self._p.rmatvec(d) if self._ph is None else self._ph @ d


class ShardedAMG:
    """The distributed V-cycle, ``z = M @ r`` on the rank's row slab (built
    by :meth:`AMGPartition.make_local`; with ``mesh=None`` it is the
    collective-free single-device twin)."""

    hermitian = True

    def __init__(self, ops, dinvs, transfers, tail, *, n_nexts, jw, smooth, smoother, lmaxs,
                 mesh=None, axis=ROWS):
        self._ops = tuple(ops)  # level operators (level 0: the solve's)
        self._dinvs = tuple(dinvs)  # this slab's 1/diag a sharded level
        self._transfers = tuple(transfers)
        self._tail = tail  # replicated AMGPreconditioner | None
        self._n_nexts = tuple(int(n) for n in n_nexts)
        self._jw = tuple(float(w) for w in jw)
        self.smooth = int(smooth)
        self.smoother = smoother
        self._lmaxs = tuple(float(v) for v in lmaxs)
        self.mesh = mesh
        self.axis = axis

    @property
    def shape(self):
        n = self._dinvs[0].shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self._dinvs[0].dtype

    @property
    def n_sharded_levels(self):
        return len(self._ops)

    def _twin(self):
        """The single-device twin (no mesh): nothing to reduce."""
        return self.mesh is None

    # -- smoothing: AMGPreconditioner's, on the sharded level operators ----
    _dinv_mul = AMGPreconditioner._dinv_mul
    _jacobi = AMGPreconditioner._jacobi
    _chebyshev = AMGPreconditioner._chebyshev
    _smooth_level = AMGPreconditioner._smooth_level

    # -- the cycle ----------------------------------------------------------
    def _vcycle(self, level, r):
        z = self._smooth_level(level, None, r, from_zero=True)
        last = level == len(self._ops) - 1
        if last and self._tail is None:
            return z  # coarsening stalled at this level: smoothing only
        d = r - self._ops[level] @ z
        partial = self._transfers[level].restrict(d)  # P_s^H d over the whole next level
        if last:
            rc = partial if self._twin() else self.mesh.all_reduce(partial, self.axis)
            e = self._tail @ rc
        elif self._twin():
            e = self._vcycle(level + 1, partial)
        else:
            e_loc = self._vcycle(level + 1, self.mesh.reduce_scatter_rows(partial, self.axis))
            e = self.mesh.all_gather_rows(e_loc, self.axis)
        z = z + self._transfers[level].prolong(e)
        return self._smooth_level(level, z, r)

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # a symmetric cycle


class AMGPartition:
    """Host-side distributed AMG; the ``M_partition`` of
    :func:`~krylov_tpu_torch.parallel.sharded_solve`.

    Built by :func:`partition_amg`.  ``make_local(A_op, mesh)`` assembles the
    rank's :class:`ShardedAMG` around the solve's own slab operator."""

    def __init__(self, *, n_shards, shape, n_pad, levels, tail, tail_kw, jw, lmaxs, smooth,
                 smoother, host_As):
        self.n_shards = int(n_shards)
        self.shape = tuple(shape)  # the global unpadded (N, N)
        self.n_pad = int(n_pad)  # the padded fine size
        self._levels = levels  # per-level dicts of numpy arrays
        self._tail = tail  # the tail's host hierarchy (amg._coarsen) | None
        self._tail_kw = tail_kw
        self._jw = tuple(jw)
        self._lmaxs = tuple(lmaxs)
        self.smooth = int(smooth)
        self.smoother = smoother
        self._host_As = host_As  # the padded scipy matrix a sharded level

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def n_sharded_levels(self):
        return len(self._levels)

    @property
    def level_sizes(self):
        sizes = tuple(a.shape[0] for a in self._host_As)
        if self._tail is not None:
            sizes = sizes + tuple(m.shape[0] for m in self._tail[0])
        return sizes

    def _tail_on(self, device):
        if self._tail is None:
            return None
        return AMGPreconditioner.from_hierarchy(self._tail, smooth=self.smooth,
                                                smoother=self.smoother, device=device,
                                                **self._tail_kw)

    def _cycle(self, ops, dinvs, transfers, device, mesh):
        return ShardedAMG(
            ops, dinvs, transfers, self._tail_on(device),
            n_nexts=[lv["n_next"] for lv in self._levels], jw=self._jw, smooth=self.smooth,
            smoother=self.smoother, lmaxs=self._lmaxs, mesh=mesh,
        )

    def make_local(self, A_op, mesh):
        """This rank's cycle on ``mesh.device`` (see the protocol in
        :mod:`krylov_tpu_torch.parallel.solve`): its slabs of every sharded
        level, around the solve's own fine-level operator ``A_op``."""
        check_local_rows("AMG", self.n_local_fine, A_op)
        s, dev = mesh.coord[ROWS], mesh.device

        def slab(a):
            return torch.from_numpy(np.ascontiguousarray(a[s])).to(dev)

        ops, dinvs, transfers = [], [], []
        for i, lv in enumerate(self._levels):
            ap = lv["Apart"]
            ops.append(A_op if ap is None else ShardedCSROperator(
                slab(ap["data"]), slab(ap["col"]), slab(ap["row"]), ap["n_local"], ap["halo"],
                ap["mode"], mesh))
            dinvs.append(slab(lv["dinv"]))
            P = _triplets_csr(lv["p_dat"][s], lv["p_rowf"][s], lv["p_colc"][s],
                              (lv["n_local"], lv["n_next"]))
            transfers.append(_Transfer(P, dev))
        return self._cycle(ops, dinvs, transfers, dev, mesh)

    def padded_matrix(self, level=0):
        """The padded scipy matrix of a sharded level (level 0: the fine
        matrix the sharded solve runs on)."""
        return self._host_As[level]

    def as_global(self, device=None):
        """The same cycle with every collective elided: a single-device
        preconditioner on the padded problem (``padded_matrix(0)``)."""
        dev = _device.resolve(device)
        ops, dinvs, transfers = [], [], []
        for i, lv in enumerate(self._levels):
            A_i = self._host_As[i]
            ops.append(_device_sparse(A_i, dev))
            d = A_i.diagonal()
            dinvs.append(torch.from_numpy(1.0 / np.where(d != 0, d, 1.0)).to(dev))
            offs = (np.arange(self.n_shards, dtype=np.int32) * lv["n_local"])[:, None]
            P = _triplets_csr(lv["p_dat"].reshape(-1), (lv["p_rowf"] + offs).reshape(-1),
                              lv["p_colc"].reshape(-1), (A_i.shape[0], lv["n_next"]))
            transfers.append(_Transfer(P, dev))
        return self._cycle(ops, dinvs, transfers, dev, None)


def partition_amg(A, n_shards, *, theta=0.08, smooth=2, omega=2.0 / 3.0, coarse_size=400,
                  max_levels=12, dtype=None, smoother="jacobi", smooth_prolongator=True,
                  n_sharded_levels=1):
    """Build a distributed smoothed-aggregation AMG hierarchy (host side).

    The keywords of :meth:`AMGPreconditioner.from_scipy
    <krylov_tpu_torch.amg.AMGPreconditioner.from_scipy>`, plus:

    * ``n_shards``: the rows-axis size of the solve's mesh.
    * ``n_sharded_levels``: how many levels stay row-partitioned before the
      hierarchy goes to the replicated tail.  1 (default) shards the fine
      level only: one ``all_reduce`` of the ~4x smaller coarse residual a
      cycle; each further sharded level trades replicated memory for a
      ``reduce_scatter_rows`` / ``all_gather_rows`` pair a cycle.

    The fine level is padded to the shard multiple as
    :func:`~krylov_tpu_torch.parallel.csr.partition_csr` pads the solve's
    matrix, so pass the SAME matrix, in the same ordering (a PET partition
    built without ``reorder=``), to both.
    """
    import scipy.sparse

    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if scipy.sparse.issparse(A) or isinstance(A, CSROperator) or hasattr(A, "toscipy"):
        A = _scipy_csr(A)
    else:
        A = scipy.sparse.csr_matrix(np.asarray(A))
    A = A.tocsr()
    if A.shape[0] != A.shape[1]:
        raise ValueError("AMG needs a square matrix")
    if dtype is not None:
        A = A.astype(dtype)
    N = A.shape[0]
    n_sharded_levels = max(1, int(n_sharded_levels))

    Al = pad_unit_diagonal(A, (-N) % n_shards)
    levels, host_As, jw, lmaxs = [], [], [], []
    A_tail = None
    for lev in range(n_sharded_levels):
        host_As.append(Al)
        d = Al.diagonal()
        dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(Al.dtype)
        n_loc = Al.shape[0] // n_shards
        lv = {
            "dinv": dinv.reshape(n_shards, n_loc),
            "n_local": n_loc,
            "Apart": None if lev == 0 else partition_csr(Al, n_shards),
        }
        step = _smoothed_prolongator(Al, theta, smooth_prolongator)
        if step is None:
            # coarsening stalled (a diagonal matrix, say): sharded smoothing
            # only, on exactly such matrices a near-exact solve
            lmax = _lmax_dinv_a(Al)
            jw.append(omega if lmax <= 2.0 else omega * 2.0 / lmax)
            lmaxs.append(lmax)
            lv.update(p_dat=np.zeros((n_shards, 1), Al.dtype),
                      p_rowf=np.zeros((n_shards, 1), np.int32),
                      p_colc=np.zeros((n_shards, 1), np.int32), n_next=1)
            levels.append(lv)
            A_tail = None
            break
        Ps, Ac, lmax = step[0], step[1], step[2]
        jw.append(omega if lmax <= 2.0 else omega * 2.0 / lmax)
        lmaxs.append(lmax)
        last_sharded = (lev + 1 == n_sharded_levels
                        or Ac.shape[0] <= max(coarse_size, 8 * n_shards))
        if not last_sharded:
            # pad the coarse level to the shard multiple so the reduce-scatter
            # tiles; P gains zero columns (nothing maps there)
            padc = (-Ac.shape[0]) % n_shards
            Ac = pad_unit_diagonal(Ac, padc)
            if padc:
                Ps = Ps.copy()
                Ps.resize((Ps.shape[0], Ac.shape[0]))
        if dtype is not None:
            Ps, Ac = Ps.astype(dtype), Ac.astype(dtype)
        dat, rowf, colc = _split_prolongator(Ps.tocsr(), n_shards)
        lv.update(p_dat=dat, p_rowf=rowf, p_colc=colc, n_next=Ac.shape[0])
        levels.append(lv)
        A_tail = Ac
        if last_sharded:
            break
        Al = Ac

    tail = None
    tail_kw = dict(omega=omega, coarse_size=coarse_size)
    if A_tail is not None:
        tail = _coarsen(A_tail, theta=theta, coarse_size=coarse_size,
                        max_levels=max(1, max_levels - len(levels)), dtype=dtype,
                        smooth_prolongator=smooth_prolongator)
    return AMGPartition(
        n_shards=n_shards, shape=A.shape, n_pad=host_As[0].shape[0], levels=levels, tail=tail,
        tail_kw=tail_kw, jw=jw, lmaxs=lmaxs, smooth=smooth, smoother=smoother,
        host_As=host_As,
    )
