"""Smoothed-aggregation algebraic multigrid preconditioner for general sparse
SPD/HPD matrices.

Counterpart of ``krylov_tpu.AMGPreconditioner``.  Where
:class:`~krylov_tpu_torch.multigrid.MultigridPreconditioner` needs a grid
stencil, AMG builds its hierarchy from the matrix alone, so it covers
variable coefficients, unstructured meshes and any symmetric sparsity.

Set-up, once, on the host (numpy and scipy, the reference's own code, so
both packages build the same hierarchy from the same matrix): strength
graph, two passes of strongest-neighbour pairwise matching (~4x coarsening
a level), the tentative piecewise-constant prolongator ``P_hat``, one
damped-Jacobi smoothing ``P = (I - w D^-1 A) P_hat`` (classic smoothed
aggregation) and the Galerkin coarse matrix ``P^H A P``.  The matching and
the Galerkin product run in the native helpers of :mod:`.ops._native`; the
numpy and scipy versions are their fallback and ground truth.

Apply, every iteration, on the levels' device: a V(s, s) cycle of
damped-Jacobi or Chebyshev smoothing.  Each level's operator is routed as
``as_operator`` routes a scipy matrix, minus the block-size probe (Galerkin
levels are never block-structured): large real float32 levels on a CUDA
device to :class:`~krylov_tpu_torch.ops.cuda_spmv.PETOperator` (kernel K10
for a vector, K11 for an ``(N, k)`` block), everything else to
:class:`~krylov_tpu_torch.ops.sparse.CSROperator`.  The SA transfer is
applied implicitly from ``P_hat`` (forward K10, and K10 on the CSR of
``P_hat^T`` to restrict; a CSR ``P_hat`` restricts through its explicit
adjoint too, so no float scatter-add runs and a cycle repeats bit for bit)
and the level operator; the coarsest level applies
a dense inverse (``torch.matmul``).  No step has a kernel of its own: the
reference computes the cycle's vector updates and the coarse product
outside any Pallas kernel too.
"""

import os
import sys
import time

import numpy as np
import torch

from . import _device
from ._operators import _prefer_pet_for_csr
from .ops import _native
from .ops.cuda_spmv import PETOperator
from .ops.sparse import CSROperator

__all__ = ["AMGPreconditioner"]


def _strength_graph(A, theta):
    """Symmetric strength of connection: keep off-diagonal (i, j) with
    |a_ij| >= theta * sqrt(|a_ii| |a_jj|); entries hold the normalized
    strength."""
    import scipy.sparse

    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    off = C.row != C.col
    r, c, v = C.row[off], C.col[off], C.data[off]
    s = np.abs(v) / np.sqrt(d[r] * d[c])
    keep = s >= theta
    return scipy.sparse.csr_matrix((s[keep], (r[keep], c[keep])), shape=A.shape)


def _first_valid_per_row(n, row_sorted, col_sorted, valid):
    """``best[i]`` = first valid column of row ``i`` in a (row ascending,
    strength descending) sorted COO stream; -1 where a row has none."""
    rv = row_sorted[valid]
    best = np.full(n, -1, dtype=np.int64)
    if rv.size:
        cv = col_sorted[valid]
        first = np.ones(rv.size, dtype=bool)
        first[1:] = rv[1:] != rv[:-1]  # rv is non-decreasing
        best[rv[first]] = cv[first]
    return best


def _pairwise_labels(A, theta, rounds=8):
    """One pass of strongest-neighbour pairwise matching.

    Luby-style rounds: every unmatched node points at its strongest
    still-unmatched neighbour and mutual pairs match (a deterministic
    symmetric jitter breaks strength ties, or uniform stencils degenerate
    into long chains).  Leftover nodes join their strongest matched
    neighbour's pair, so aggregates have 1-4 nodes.  Returns ``(labels,
    n_agg)``.

    The native twin (``csrc/host/amg_agg.cpp``, label-identical) runs first;
    this numpy version is its fallback and ground truth."""
    if A.has_sorted_indices:
        native = _native.amg_pairwise_labels_native(A, theta, rounds)
        if native is not None:
            return native
    n = A.shape[0]
    S = _strength_graph(A, theta).tocoo()
    r, c, s = S.row.astype(np.int64), S.col.astype(np.int64), S.data
    if s.size:
        u, v = np.minimum(r, c), np.maximum(r, c)
        jitter = ((u * 2654435761 + v * 40503) % (1 << 20)) / float(1 << 20)
        s = s * (1.0 + 1e-6 * jitter)
        # sort by (row ascending, strength descending): rows are 2 apart and
        # strengths mapped into (0, 1), so rows never interleave
        key = r * 2.0 - (s / (abs(s.max()) + 1.0)) * 0.5
        order = np.argsort(key, kind="stable")
        r, c = r[order], c[order]

    unmatched = np.ones(n, dtype=bool)
    mate = np.full(n, -1, dtype=np.int64)
    i = np.arange(n)
    for _ in range(rounds):
        if not unmatched.any() or s.size == 0:
            break
        best = _first_valid_per_row(n, r, c, unmatched[r] & unmatched[c])
        ok = (best >= 0) & unmatched
        mutual = ok & (best[np.clip(best, 0, n - 1)] == i) & (i < best)
        a, b_ = i[mutual], best[mutual]
        if a.size == 0:
            break
        mate[a], mate[b_] = b_, a
        unmatched[a] = unmatched[b_] = False

    labels = np.full(n, -1, dtype=np.int64)
    pair_lead = (mate >= 0) & (i < mate)
    leads = np.flatnonzero(pair_lead)
    labels[leads] = np.arange(leads.size)
    labels[mate[leads]] = labels[leads]
    # leftovers join their strongest already-labelled neighbour
    if unmatched.any() and s.size:
        best = _first_valid_per_row(n, r, c, unmatched[r] & ~unmatched[c])
        join = unmatched & (best >= 0)
        labels[join] = labels[np.clip(best, 0, n - 1)][join]
        unmatched[join] = False
    # true isolates become singletons
    singles = np.flatnonzero(labels < 0)
    labels[singles] = leads.size + np.arange(singles.size)
    return labels, leads.size + singles.size


def _aggregate(A, theta):
    """Double pairwise matching (two passes: ~4x coarsening).

    The composed labels are renumbered by first occurrence along the fine
    ordering: the same partition, with the coarse unknowns (and so the
    Galerkin matrix and ``P_hat``'s columns) in fine-row order."""
    import scipy.sparse

    l1, n1 = _pairwise_labels(A, theta)
    # A1 = Q1^T A Q1 for the one-nonzero-a-row aggregation Q1 is a
    # relabel-and-sum of A's entries: the native Galerkin product with no
    # prolongator smoothing, or one coo -> csr pass
    A1 = None
    if A.has_sorted_indices and not np.iscomplexobj(A.data):
        A1 = _native.amg_rap_native(A, l1, n1, None)
    if A1 is None:
        C = A.tocoo()
        A1 = scipy.sparse.csr_matrix((C.data, (l1[C.row], l1[C.col])), shape=(n1, n1))
        A1.sort_indices()  # canonical for both matching paths
    l2, n2 = _pairwise_labels(A1, theta)
    labels = l2[l1]
    first_pos = np.sort(np.unique(labels, return_index=True)[1])
    rank = np.empty(n2, np.int64)
    rank[labels[first_pos]] = np.arange(n2)
    return rank[labels], n2


def _lmax_dinv_a(Al, iters=12):
    """``lmax(D^-1 A)`` by a short host power iteration, matrix-free (``y =
    (A x) / d``), with the iterate in ``Al``'s real dtype."""
    d = Al.diagonal()
    d = np.where(d != 0, d, 1.0)
    rdtype = np.empty(0, Al.dtype).real.dtype
    x = np.random.default_rng(0).standard_normal(Al.shape[0]).astype(rdtype)
    x /= np.linalg.norm(x)
    lmax = 1.0
    for _ in range(iters):
        y = (Al @ x) / d
        lmax = float(np.linalg.norm(y))
        if lmax == 0.0:
            return 1.0
        x = y / lmax
    return lmax


def _lmax_gershgorin(Al):
    """Gershgorin bound ``lmax(D^-1 A) <= max_i sum_j |a_ij| / |d_i|``: one
    O(nnz) pass, always an overestimate (the safe side for every weight it
    feeds)."""
    if Al.nnz == 0:
        return 1.0
    d = np.abs(Al.diagonal())
    d = np.where(d > 0, d, 1.0)
    row_ids = np.repeat(np.arange(Al.shape[0]), np.diff(Al.indptr))
    rowsum = np.bincount(row_ids, weights=np.abs(Al.data), minlength=Al.shape[0])
    return float(np.max(rowsum / d))


def _lmax_estimate(Al, lmax_method):
    if lmax_method == "gershgorin":
        return _lmax_gershgorin(Al)
    if lmax_method == "power":
        return _lmax_dinv_a(Al)
    raise ValueError(f"unknown lmax_method {lmax_method!r}")


def _smoothed_prolongator(Al, theta, smooth_prolongator, lmax_method="power", need_P=True):
    """One coarsening step: aggregate, build the tentative prolongator
    ``P_hat``, optionally smooth it (``P = (I - w D^-1 A) P_hat``, as a
    row-scaled ``A @ P_hat``), and return ``(P, A_coarse, lmax, labels,
    n_agg)``, or None when coarsening stalls.

    ``need_P=False`` (the single-device hierarchy, which applies the SA
    transfer implicitly) takes the native Galerkin product and returns
    ``P=None``; the scipy triple product is its fallback and ground truth."""
    import scipy.sparse

    labels, n_agg = _aggregate(Al, theta)
    if n_agg >= 0.9 * Al.shape[0]:
        return None  # coarsening stalled (a diagonal matrix, say)
    lmax = _lmax_estimate(Al, lmax_method)
    if not need_P and Al.has_sorted_indices:
        scale = None
        if smooth_prolongator:
            d = Al.diagonal()
            d = np.where(d != 0, d, 1.0)
            scale = (4.0 / (3.0 * lmax)) / np.real(d)
        Ac = _native.amg_rap_native(Al, labels, n_agg, scale)
        if Ac is not None:
            return None, Ac, lmax, labels, n_agg
    P = scipy.sparse.csr_matrix(
        (np.ones(Al.shape[0], Al.dtype), (np.arange(Al.shape[0]), labels)),
        shape=(Al.shape[0], n_agg),
    )
    if smooth_prolongator:
        # w = 4/(3 lmax): the classic SA prolongator smoother
        AP = (Al @ P).tocsr()
        d = Al.diagonal()
        d = np.where(d != 0, d, 1.0)
        scale = (4.0 / (3.0 * lmax)) / d
        AP.data *= np.repeat(scale, np.diff(AP.indptr))
        P = (P - AP).tocsr()
    # conjugate(copy=False) returns P itself for real dtypes
    Ac = (P.conjugate(copy=False).T @ Al @ P).tocsr()
    Ac.sort_indices()  # canonical: the next level's matching needs it
    return P, Ac, lmax, labels, n_agg


def _coarsen(A, *, theta=0.08, coarse_size=400, max_levels=12, dtype=None,
             smooth_prolongator=True, lmax_method="power"):
    """The host half of the set-up: ``(levels, phats, p_ws, lmaxs)``, the
    level matrices (fine first), the tentative prolongators, the prolongator
    smoothing weights and the ``lmax(D^-1 A)`` estimates, as scipy matrices
    and floats (see :meth:`AMGPreconditioner.from_scipy` for the keywords)."""
    import scipy.sparse

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    A = A.tocsr()
    if A.shape[0] != A.shape[1]:
        raise ValueError("AMG needs a square matrix")
    if dtype is not None:
        A = A.astype(dtype, copy=False)  # no copy when already dtype
    if not (A.has_canonical_format and A.has_sorted_indices):
        A = A.copy()  # canonicalize our copy, not the caller's matrix
        A.sum_duplicates()
        A.sort_indices()

    levels, phat_sps, p_ws, lmaxs = [A], [], [], []
    while levels[-1].shape[0] > coarse_size and len(levels) < max_levels:
        step = _smoothed_prolongator(levels[-1], theta, smooth_prolongator,
                                     lmax_method=lmax_method, need_P=False)
        if step is None:
            break  # coarsening stalled
        _, Ac, lmax, labels, n_agg = step
        lmaxs.append(lmax)
        if dtype is not None:
            Ac = Ac.astype(dtype, copy=False)
        p_ws.append(float(4.0 / (3.0 * lmax)) if smooth_prolongator else None)
        nf = labels.shape[0]
        phat_sps.append(scipy.sparse.csr_matrix(
            (np.ones(nf, Ac.dtype), (np.arange(nf), labels)), shape=(nf, int(n_agg))))
        levels.append(Ac)
    return levels, phat_sps, p_ws, lmaxs


def _device_sparse(sp, device):
    """A set-up scipy matrix as the operator the cycle applies on
    ``device``: the routing of ``as_operator`` minus its block-size probe."""
    if not _prefer_pet_for_csr(sp, device):
        return CSROperator.from_scipy(sp, device=device)
    if sp.shape[0] == sp.shape[1]:
        # a level: symmetric, so the cycle never needs its adjoint
        return PETOperator.from_scipy(sp, with_rmatvec=False, reorder="auto", device=device)
    # a tentative prolongator, whose adjoint restricts: built now, since no
    # lazy handle may keep the set-up's scipy matrix alive
    return PETOperator.from_scipy(sp, with_rmatvec=True, device=device)


def _tensor(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class AMGPreconditioner:
    """``z = M @ r`` runs one smoothed-aggregation AMG V-cycle.

    Build with :meth:`from_scipy`; use as the ``M`` of cg/minres (or the
    ``Ml`` of the two-sided family) in either backend.  Takes 1-D and
    blocked ``(N, k)`` right-hand sides.  ``setup_seconds`` holds the
    set-up's wall time by phase (empty for a hierarchy built from parts).
    """

    hermitian = True

    def __init__(self, ops, phats, dinvs, coarse_inv, smooth, omega, smoother="jacobi",
                 lmaxs=(), coarse_op=None, coarse_dinv=None, p_w=()):
        self._ops = tuple(ops)
        # the SA prolongator P = (I - w D^-1 A) P_hat is applied implicitly:
        # only the tentative P_hat (one nonzero a row) and its adjoint are
        # operators; p_w[level] is w, or None for unsmoothed aggregation
        self._phats = tuple(phats)
        # a CSR prolongator restricts through its explicit adjoint (a matvec,
        # no scatter-add); PETOperator holds one already
        self._phat_adjs = tuple(p.adjoint() if isinstance(p, CSROperator) else None
                                for p in self._phats)
        self._p_w = tuple(p_w) or (None,) * len(self._phats)
        self._dinvs = tuple(dinvs)
        self._coarse_inv = coarse_inv
        self._coarse_op = coarse_op
        self._coarse_dinv = coarse_dinv
        self.smooth = int(smooth)
        self.omega = float(omega)
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self._lmaxs = tuple(float(v) for v in lmaxs)
        # convergent damped Jacobi needs w * lmax(D^-1 A) < 2; omega is
        # calibrated for lmax ~ 2 (M-matrices), so a level whose spectrum
        # reaches higher gets its weight scaled down
        self._jw = tuple(
            self.omega if lm <= 2.0 else self.omega * 2.0 / lm for lm in self._lmaxs
        ) or (self.omega,) * len(self._ops)
        self.setup_seconds = {}

    @classmethod
    def from_scipy(cls, A, *, theta=0.08, smooth=2, omega=2.0 / 3.0, coarse_size=400,
                   max_levels=12, dtype=None, smooth_prolongator=True, smoother="jacobi",
                   lmax_method="power", fine_operator=None, device=None):
        """Build the hierarchy from a scipy sparse (or dense) SPD matrix.

        * ``theta``: strength threshold on the normalized coupling
          ``|a_ij| / sqrt(a_ii a_jj)``.
        * ``smooth`` / ``omega``: damped-Jacobi sweeps a level, before and
          after the coarse correction (symmetric, so CG accepts the cycle).
        * ``coarse_size``: stop coarsening here and invert densely.
        * ``dtype``: numpy dtype of the levels (default the matrix's; pass
          ``np.float32`` on the GPU so the large levels take K10/K11).
        * ``smooth_prolongator``: classic SA's one-pass Jacobi smoothing of
          the prolongator; off gives plain pairwise aggregation.
        * ``smoother``: ``"jacobi"`` (``smooth`` damped sweeps) or
          ``"chebyshev"`` (a degree ``smooth + 1`` polynomial in ``D^-1 A``
          over ``[lmax/30, lmax]``: one more matvec, no inner products).
        * ``lmax_method``: the per-level ``lmax(D^-1 A)`` estimate,
          ``"power"`` (12 host matvecs a level) or ``"gershgorin"`` (one
          O(nnz) pass, a safe overestimate).
        * ``fine_operator``: an operator of the same matrix that the solve
          already holds (the ``PETOperator`` it applies, say), reused as
          level 0: the largest level is neither built nor stored twice.
        * ``device``: where the levels go (default the default device).

        ``KRYLOV_TORCH_AMG_PROFILE=1`` prints the set-up's phases to stderr.
        """
        device = _device.resolve(device)
        seconds = {}
        t0 = time.perf_counter()

        def mark(phase):
            nonlocal t0
            t1 = time.perf_counter()
            seconds[phase] = t1 - t0
            if os.environ.get("KRYLOV_TORCH_AMG_PROFILE") == "1":
                print(f"[amg-setup] {phase}: {t1 - t0:.3f}s", file=sys.stderr, flush=True)
            t0 = t1

        hierarchy = _coarsen(A, theta=theta, coarse_size=coarse_size, max_levels=max_levels,
                             dtype=dtype, smooth_prolongator=smooth_prolongator,
                             lmax_method=lmax_method)
        mark("coarsening (labels + Galerkin RAP)")
        self = cls.from_hierarchy(hierarchy, smooth=smooth, omega=omega, smoother=smoother,
                                  coarse_size=coarse_size, lmax_method=lmax_method,
                                  fine_operator=fine_operator, device=device, _mark=mark)
        self.setup_seconds = seconds
        return self

    @classmethod
    def from_hierarchy(cls, hierarchy, *, smooth=2, omega=2.0 / 3.0, smoother="jacobi",
                       coarse_size=400, lmax_method="power", fine_operator=None, device=None,
                       _mark=None):
        """The cycle over a hierarchy that :func:`_coarsen` built on the
        host (scipy matrices only, so it pickles): its operators, tentative
        prolongators, diagonals and coarsest solve go to ``device``; the
        keywords are :meth:`from_scipy`'s."""
        device = _device.resolve(device)
        mark = _mark or (lambda phase: None)
        levels, phat_sps, p_ws, lmaxs = hierarchy
        build = levels[:-1]
        if fine_operator is not None and build:
            build = build[1:]
        ops = [_device_sparse(m, device) for m in build]
        if fine_operator is not None and levels[:-1]:
            ops = [fine_operator] + ops
        phats = [_device_sparse(p, device) for p in phat_sps]
        mark("operator builds (K10 CSR / CSR, on the device)")

        dinvs = []
        for m in levels[:-1]:
            d = m.diagonal()
            dinvs.append(_tensor(1.0 / np.where(d != 0, d, 1.0), device))
        n_last = levels[-1].shape[0]
        coarse_inv = coarse_op = coarse_dinv = None
        if n_last <= max(coarse_size, 4096):
            coarse_inv = _tensor(np.linalg.inv(levels[-1].toarray()), device)
        else:
            # coarsening stalled while the level is too large to densify (an
            # empty strength graph, say): damped-Jacobi sweeps, near-exact
            # on exactly such diagonally dominant matrices
            coarse_op = _device_sparse(levels[-1], device)
            d = levels[-1].diagonal()
            d = np.where(d != 0, d, 1.0)
            lmax_c = _lmax_estimate(levels[-1], lmax_method)
            # the weight folds into the vector: only Jacobi sweeps use it
            scale = omega if lmax_c <= 2.0 else omega * 2.0 / lmax_c
            coarse_dinv = _tensor(scale / d, device)
        self = cls(ops, phats, dinvs, coarse_inv, smooth, omega, smoother=smoother,
                   lmaxs=lmaxs[: len(ops)], coarse_op=coarse_op, coarse_dinv=coarse_dinv,
                   p_w=p_ws)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the copies are part of the set-up
        mark("coarse inverse + assembly")
        return self

    # -- observables ----------------------------------------------------
    @property
    def _coarse(self):
        return self._coarse_inv if self._coarse_inv is not None else self._coarse_dinv

    @property
    def shape(self):
        n = self._dinvs[0].shape[0] if self._dinvs else self._coarse.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self._coarse.dtype

    @property
    def device(self):
        return self._coarse.device

    @property
    def n_levels(self):
        return len(self._ops) + 1

    @property
    def level_sizes(self):
        return tuple(d.shape[0] for d in self._dinvs) + (self._coarse.shape[0],)

    # -- the cycle -------------------------------------------------------
    def _dinv_mul(self, level, v):
        d = self._dinvs[level]
        return d.reshape(tuple(d.shape) + (1,) * (v.ndim - 1)) * v

    def _jacobi(self, level, z, r, iters, from_zero=False):
        A = self._ops[level]
        w = self._jw[level]
        if from_zero:
            z = w * self._dinv_mul(level, r)
            iters -= 1
        for _ in range(iters):
            z = z + w * self._dinv_mul(level, r - A @ z)
        return z

    def _chebyshev(self, level, z, r, from_zero=False):
        """Degree ``smooth + 1`` Chebyshev polynomial in ``D^-1 A`` over the
        upper spectrum ``[lmax/30, lmax]``: one matvec a degree, no inner
        products (the multigrid smoother of Adams et al. 2003)."""
        A = self._ops[level]
        lmax = 1.1 * self._lmaxs[level]  # a safety margin on the estimate
        lmin = lmax / 30.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        res = self._dinv_mul(level, r if from_zero else r - A @ z)
        if from_zero:
            z = torch.zeros_like(r)
        d = res / theta
        for _ in range(self.smooth):
            z = z + d
            res = res - self._dinv_mul(level, A @ d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return z + d

    def _smooth_level(self, level, z, r, from_zero=False):
        if self.smoother == "chebyshev":
            return self._chebyshev(level, z, r, from_zero=from_zero)
        return self._jacobi(level, z, r, self.smooth, from_zero=from_zero)

    def _vcycle(self, level, r):
        if level == len(self._ops):
            if self._coarse_inv is not None:
                dt = torch.promote_types(self._coarse_inv.dtype, r.dtype)
                return torch.matmul(self._coarse_inv.to(dt), r.to(dt))
            # stalled-coarsening fallback: damped-Jacobi sweeps (the weight
            # is folded into coarse_dinv)
            w = self._coarse_dinv.reshape(
                tuple(self._coarse_dinv.shape) + (1,) * (r.ndim - 1))
            z = w * r
            for _ in range(max(8, 2 * self.smooth)):
                z = z + w * (r - self._coarse_op @ z)
            return z
        z = self._smooth_level(level, None, r, from_zero=True)
        d = r - self._ops[level] @ z
        e = self._vcycle(level + 1, self._restrict_level(level, d))
        z = z + self._prolong_level(level, e)
        return self._smooth_level(level, z, r)

    # -- implicit smoothed-aggregation transfer --------------------------
    # P^H d = P_hat^T (I - w A D^-1) d   (A hermitian, D real positive)
    def _restrict_level(self, level, d):
        w = self._p_w[level]
        if w is not None:
            d = d - w * (self._ops[level] @ self._dinv_mul(level, d))
        adj = self._phat_adjs[level]
        return self._phats[level].rmatvec(d) if adj is None else adj @ d

    # P e = (I - w D^-1 A) P_hat e
    def _prolong_level(self, level, e):
        z = self._phats[level] @ e
        w = self._p_w[level]
        if w is not None:
            z = z - w * self._dinv_mul(level, self._ops[level] @ z)
        return z

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # a symmetric cycle
