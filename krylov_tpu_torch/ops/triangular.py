"""Triangular solves (counterpart of ``krylov_tpu.ops.triangular``): small
dense ones batched over trailing right-hand-side dimensions, the grid
sweeps of a stencil's triangle, and level-scheduled sparse ones.

The reference has no TPU kernel here; it runs the sweeps as XLA loops.  On
a CUDA device the grid sweeps launch S1 and the level-scheduled sweeps S2,
hand-written kernels (:mod:`.cuda_triangular`, ``csrc/triangular.cu``), one
launch a sweep (a few for a factor with wide levels); on the CPU they run
their plain versions, the Python loops of this module (``plain``).  scipy
is imported inside the functions that decompose a factor on the host; the
dependency levels come from the native set-up helper (:mod:`._native`)
where it is built, else from a numpy pass.
"""

import numpy as np
import torch

from .. import _device
from . import _native, cuda_triangular
from .sparse import _segment_sum


def multi_solve_triangular(A, B, lower=False):
    """Solve ``A[:, :, t] @ y[:, t] = B[:, t]`` for every trailing index t.

    ``A`` has shape ``(k, k, *tail)``, ``B`` has ``(k, *tail)``.  Columns of
    ``B`` that are entirely zero yield zero solutions, guarding the singular
    ``R`` of already-converged right-hand-side columns, as the reference.
    """
    k = A.shape[0]
    tail = tuple(B.shape[1:])
    a = A.reshape(k, k, -1).permute(2, 0, 1)  # (t, k, k)
    bb = B.reshape(k, -1).T  # (t, k)
    zero_col = torch.all(bb == 0, dim=1)  # (t,)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    a_safe = torch.where(zero_col[:, None, None], eye, a)
    sol = torch.linalg.solve_triangular(a_safe, bb.to(A.dtype)[:, :, None], upper=not lower)
    sol = torch.where(zero_col[:, None], 0, sol[:, :, 0])
    return sol.T.reshape((k,) + tail)


# ---------------------------------------------------------------------------
# Grid sweeps: triangular solves with the triangle of a grid stencil
# ---------------------------------------------------------------------------


class GridLowerSweep:
    """Forward substitution ``(D/omega + L) x = b`` for the lower triangle
    of a grid stencil, prepared once and applied to many right-hand sides
    (the plan behind :func:`grid_lower_sweep`).

    On a CUDA device a call is one launch of S1
    (:func:`.cuda_triangular.grid_sweep`), prepared here as its
    :class:`~.cuda_triangular.GridPlan` (``plan``).  On the CPU it runs the
    plain version, :meth:`plain`: grid rows are inherently sequential, so a
    Python loop walks them, each row reading the ``h`` solved rows above it.
    Within a row the first-order recurrence ``x[j] = a[j] x[j-1] + c[j]``
    (``a = -l/d``, ``c = rhs/d``) is solved in ``ceil(log2 ny)`` doubling
    steps: step ``s`` replaces ``(a, c)[j]`` by ``(a[j] a[j-s], c[j] + a[j]
    c[j-s])``.  The ``a`` side depends on the coefficients alone, so it is
    computed for all rows at once (``ceil(log2 ny)`` planes of the grid's
    size, built on the CPU at set-up and elsewhere only at a first
    :meth:`plain` call) and a row's sweep costs two launches a step.  The
    orders of operations differ from each other's and from a work-efficient
    scan's, so results agree with the reference's to rounding, not bit for
    bit.
    """

    def __init__(self, coeffs2d, row_offsets, col_offsets, omega=1.0, dtype=None):
        ndiag, M, ny = coeffs2d.shape
        dtype = coeffs2d.dtype if dtype is None else dtype
        self.grid = (M, ny)
        self.dtype = dtype
        self.plan = None
        self._plain_args = (coeffs2d, row_offsets, col_offsets, omega)
        self.a_steps = None
        if coeffs2d.device.type == "cpu":
            self._build_plain()
        else:
            self.plan = cuda_triangular.grid_plan(coeffs2d, row_offsets, col_offsets, omega,
                                                  dtype, upper=False)

    def _build_plain(self):
        coeffs2d, row_offsets, col_offsets, omega = self._plain_args
        ny = coeffs2d.shape[2]
        dtype = self.dtype
        diag_d, sub_d, bands = cuda_triangular.grid_bands(row_offsets, col_offsets, upper=False)
        sub = None if sub_d is None else coeffs2d[sub_d]  # within-row (0, -1) band
        diag = (coeffs2d[diag_d] / omega).to(dtype)
        # (dr < 0, dc, plane) of the rows above
        self.row_bands = [(-back, dc, coeffs2d[d].to(dtype)) for d, back, dc in bands]
        self.dsafe = torch.where(diag != 0, diag, 1.0)
        a = torch.zeros_like(diag)
        if sub is not None:
            a = torch.where(diag != 0, -sub.to(dtype) / self.dsafe, 0.0)
        a[:, 0] = 0.0
        # a_steps[t][i, j]: the product a[i, j] a[i, j-1] ... over 2^t terms,
        # zero where it would reach column 0 (a[i, 0] = 0): the factor of
        # c[j - 2^t] at doubling step t
        self.a_steps = []
        s = 1
        while s < ny:
            self.a_steps.append(a)
            nxt = torch.zeros_like(a)
            nxt[:, s:] = a[:, s:] * a[:, :-s]
            a = nxt
            s *= 2

    def __call__(self, b2):
        """``b2``: ``(M, ny)`` or a batch ``(..., M, ny)``; returns the same
        shape in the promoted type of the plan and ``b2``."""
        return cuda_triangular.grid_sweep(self.plan, b2, self.plain)

    def plain(self, b2):
        """The plain version, on the plan's device."""
        if self.a_steps is None:
            self._build_plain()
        M, ny = self.grid
        b2 = b2.to(torch.promote_types(self.dtype, b2.dtype))
        fused = b2.dtype == self.dtype  # addcmul takes one dtype
        rows = []
        for i in range(M):
            rhs = b2[..., i, :]
            for dr, dc, plane in self.row_bands:
                if i + dr < 0:
                    continue  # rows above the grid read as zero
                prev = rows[i + dr]
                if dc:
                    # shift within the row; out-of-range killed by zero coeffs
                    prev = torch.roll(prev, -dc, dims=-1)
                rhs = rhs - plane[i] * prev
            c = rhs / self.dsafe[i]
            s = 1
            for a_s in self.a_steps:
                # columns j < s wrap around under a zero factor
                shifted = torch.roll(c, s, dims=-1)
                c = torch.addcmul(c, a_s[i], shifted) if fused else c + a_s[i] * shifted
                s *= 2
            rows.append(c)
        return torch.stack(rows, dim=-2)


class GridUpperSweep:
    """Backward substitution for the upper triangle of a grid stencil.

    On a CUDA device one launch of S1, which walks the rows from the last
    and each row from its right end, with no flipped copies.  The plain
    version reverses both grid axes, which maps the upper triangle onto a
    lower one (band ``(dr, dc)`` becomes ``(-dr, -dc)`` with its coefficient
    plane flipped): a :class:`GridLowerSweep` of the flipped planes.
    """

    def __init__(self, coeffs2d, row_offsets, col_offsets, omega=1.0, dtype=None):
        self.grid = tuple(coeffs2d.shape[1:])
        self.dtype = coeffs2d.dtype if dtype is None else dtype
        self.plan = None
        self._lower = None
        self._plain_args = (coeffs2d, row_offsets, col_offsets, omega)
        if coeffs2d.device.type == "cpu":
            self._build_plain()
        else:
            self.plan = cuda_triangular.grid_plan(coeffs2d, row_offsets, col_offsets, omega,
                                                  self.dtype, upper=True)

    def _build_plain(self):
        coeffs2d, row_offsets, col_offsets, omega = self._plain_args
        self._lower = GridLowerSweep(
            torch.flip(coeffs2d, dims=(-2, -1)),
            tuple(-r for r in row_offsets), tuple(-c for c in col_offsets),
            omega=omega, dtype=self.dtype,
        )

    def __call__(self, b2):
        return cuda_triangular.grid_sweep(self.plan, b2, self.plain)

    def plain(self, b2):
        """The plain version, on the plan's device."""
        if self._lower is None:
            self._build_plain()
        return torch.flip(self._lower.plain(torch.flip(b2, dims=(-2, -1))), dims=(-2, -1))


def grid_lower_sweep(coeffs2d, row_offsets, col_offsets, b2, omega=1.0):
    """Forward substitution for the lower triangle of a grid stencil.

    Solves ``(D/omega + L) x = b`` where ``D + L`` is the lower-triangular
    part of a :class:`~krylov_tpu_torch.ops.stencil.GridStencilOperator`
    whose within-row coupling is first-order (``col_offsets`` subset of
    {0, -1} on the ``dr == 0`` bands), true for all the grid Laplacians
    here.  ``coeffs2d``: ``(ndiag, M, ny)`` with matching row/col offsets
    (upper bands may be present; they are ignored).  ``b2``: ``(M, ny)``, or
    a batch ``(..., M, ny)`` solved in one pass (each right-hand side's
    result is what a pass of its own gives).  See :class:`GridLowerSweep`.
    """
    dtype = torch.promote_types(coeffs2d.dtype, b2.dtype)
    return GridLowerSweep(coeffs2d, row_offsets, col_offsets, omega, dtype)(b2)


def grid_upper_sweep(coeffs2d, row_offsets, col_offsets, b2, omega=1.0):
    """Backward substitution for the upper triangle of a grid stencil (see
    :class:`GridUpperSweep`)."""
    dtype = torch.promote_types(coeffs2d.dtype, b2.dtype)
    return GridUpperSweep(coeffs2d, row_offsets, col_offsets, omega, dtype)(b2)


# ---------------------------------------------------------------------------
# Level-scheduled sparse triangular solves
# ---------------------------------------------------------------------------


def _dependency_levels(indptr, indices, n, lower, max_levels):
    """Level of each row of a triangular factor (row i is in level ``1 +
    max(level of its strictly-triangular neighbours)``), by frontier sweeps
    in numpy: the rows whose neighbours are all solved form the next level.
    Returns ``(level, nlev)``; stops counting once ``nlev`` exceeds
    ``max_levels`` (a deep chain would take a sweep a level)."""
    import scipy.sparse

    row_of = np.repeat(np.arange(n), np.diff(indptr))
    off = indices < row_of if lower else indices > row_of
    # column j of `deps` lists the rows that wait for row j
    deps = scipy.sparse.csc_matrix(
        (np.ones(int(off.sum()), np.int8), (row_of[off], indices[off])), shape=(n, n))
    waiting = np.bincount(row_of[off], minlength=n)
    level = np.zeros(n, np.int64)
    frontier = np.flatnonzero(waiting == 0)
    nlev = 1 if n else 0
    done = len(frontier)
    while done < n:
        if nlev > max_levels:
            return level, nlev + 1
        starts, ends = deps.indptr[frontier], deps.indptr[frontier + 1]
        lens = ends - starts
        # entries of the frontier's columns, without a Python loop over them
        idx = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(int(lens.sum()))
        hit = deps.indices[idx]
        waiting -= np.bincount(hit, minlength=n)
        cand = np.unique(hit)
        frontier = cand[waiting[cand] == 0]
        level[frontier] = nlev
        nlev += 1
        done += len(frontier)
    return level, max(nlev, 1)


def level_arrays(sp_tri, lower=True, max_levels=1024):
    """Host-side dependency-level decomposition of a triangular factor.

    Returns ``(n, [(rows, diag, dat, col, lrow), ...])`` as numpy arrays,
    one tuple per level: the raw material for
    :class:`LevelScheduledTriangularSolve` and :class:`StackedTriangularSweep`.
    Within a level the entries are in row order, so ``lrow`` is sorted."""
    import scipy.sparse

    sp = scipy.sparse.csr_matrix(sp_tri)
    sp.sort_indices()
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, sp.data

    level = _native.tri_levels_native(sp, lower)  # one O(nnz) pass in C++
    if level is not None:
        nlev = int(level.max()) + 1 if n else 1
    else:  # the numpy frontier pass: fallback and ground truth
        level, nlev = _dependency_levels(indptr, indices, n, lower, max_levels)
    if nlev > max_levels:
        raise NotImplementedError(
            f"triangular factor has more than {max_levels} dependency levels; "
            "use the banded/grid scan sweeps or a Krylov method for deep chains"
        )

    diag = sp.diagonal()
    if np.any(diag == 0):
        raise ValueError("triangular factor has zeros on the diagonal")

    # group rows and entries by level in one stable sort each
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    off = indices < row_of if lower else indices > row_of
    rorder = np.argsort(level, kind="stable")
    rsplit = np.split(rorder, np.cumsum(np.bincount(level, minlength=nlev))[:-1])
    ent = np.flatnonzero(off)
    elev = level[row_of[ent]]
    eorder = ent[np.argsort(elev, kind="stable")]
    esplit = np.split(eorder, np.cumsum(np.bincount(elev, minlength=nlev))[:-1])
    levels = []
    for l in range(nlev):
        rows = rsplit[l]
        sel = esplit[l]
        lrow = np.searchsorted(rows, row_of[sel])
        levels.append((rows, diag[rows], data[sel], indices[sel], lrow))
    return n, levels


def make_triangular_solve(sp_tri, lower=True, max_levels=4096, unroll_threshold=64,
                          device=None):
    """Pick the level-scheduled solve for a factor's depth, as the
    reference does: shallow factors (<= ``unroll_threshold`` levels) get
    :class:`LevelScheduledTriangularSolve` (each level at its own size),
    deeper ones :class:`StackedTriangularSweep` (levels padded to one
    shape).  On a CUDA device both launch S2 (a launch for each run of
    narrow levels and each wide level); on the CPU both run a stage per
    level in a Python loop.  The arrays go to ``device`` (the default device
    when None)."""
    n, levels = level_arrays(sp_tri, lower=lower, max_levels=max_levels)
    if len(levels) <= unroll_threshold:
        return LevelScheduledTriangularSolve(
            sp_tri, lower=lower, max_levels=max_levels, device=device, _levels=(n, levels)
        )
    rows, diag, dat, col, lrow = stacked_level_arrays(
        [sp_tri], n, lower=lower, max_levels=max_levels, _per=[levels]
    )
    device = _device.resolve(device)
    return StackedTriangularSweep(
        *(torch.from_numpy(a[0]).to(device) for a in (rows, diag, dat, col, lrow)), n
    )


def stacked_level_arrays(factors, n, lower=True, max_levels=4096, dtype=None, _per=None):
    """Pad the dependency levels of one or more same-size triangular
    factors to a common ``(nlev, mr/mn)`` shape (leading axis = factor).

    The padding is exact, not approximate: padded rows write the dummy
    slot ``n`` of the extended vector with unit diagonal, padded entries
    carry zero data and sum into the dummy segment ``mr``, and factors with
    fewer levels get identity tail steps.  Feed one factor's slice to
    :class:`StackedTriangularSweep`."""
    per = _per if _per is not None else [
        level_arrays(f, lower=lower, max_levels=max_levels)[1] for f in factors
    ]
    if dtype is None:
        dtype = per[0][0][1].dtype if per and per[0] else np.float64
    S = len(per)
    nlev = max(len(p) for p in per)
    mr = max((len(lv[0]) for p in per for lv in p), default=0) or 1
    mn = max((len(lv[2]) for p in per for lv in p), default=0) or 1
    rows = np.full((S, nlev, mr), n, np.int32)
    diag = np.ones((S, nlev, mr), dtype)
    dat = np.zeros((S, nlev, mn), dtype)
    col = np.full((S, nlev, mn), n, np.int32)
    lrow = np.full((S, nlev, mn), mr, np.int32)
    for s, p in enumerate(per):
        for l, (r_, d_, v_, c_, lr_) in enumerate(p):
            rows[s, l, : len(r_)] = r_
            diag[s, l, : len(r_)] = d_
            dat[s, l, : len(v_)] = v_
            col[s, l, : len(v_)] = c_
            lrow[s, l, : len(v_)] = lr_
    return rows, diag, dat, col, lrow


def _tail(t, ndim):
    """``t`` with trailing unit axes, to broadcast over right-hand sides."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - 1))


def _level_offsets(lrow, nseg):
    """Segment offsets ``(nseg + 1,)`` of a sorted local-row index."""
    return torch.searchsorted(
        lrow, torch.arange(nseg + 1, dtype=lrow.dtype, device=lrow.device))


class StackedTriangularSweep:
    """Triangular solve over dependency levels padded to a common shape.

    Same mathematics as :class:`LevelScheduledTriangularSolve`; the levels
    come padded (:func:`stacked_level_arrays`), so every stage has the same
    shape: ``rows, diag (nlev, mr)``, ``dat, col, lrow (nlev, mn)``.  On a
    CUDA device a call launches S2 on the real rows and entries
    (``schedule``, a :class:`~.cuda_triangular.LevelSchedule` made here on
    the host; padding does no work).  The plain version, :meth:`plain`,
    sums each level's entries per row by ``_segment_sum`` in their stored
    order (``lrow`` is sorted within a level); S2 sums them in the same
    order, one row at a time.  A solve repeats bit for bit on either device.
    """

    def __init__(self, rows, diag, dat, col, lrow, n_local):
        self.rows, self.diag = rows.long(), diag
        self.dat, self.col, self.lrow = dat, col.long(), lrow.long()
        self.n_local = int(n_local)
        # the plain version's segment offsets: made here on the CPU, at its
        # first call elsewhere (a launch a level, which a sharded solve's
        # set-up on the card would pay every call)
        self._offsets = self._level_offsets() if rows.device.type == "cpu" else None
        host = [t.cpu().numpy() for t in (self.rows, self.diag, self.dat, self.col, self.lrow)]
        self.schedule = cuda_triangular.LevelSchedule(
            cuda_triangular.stacked_levels(*host, self.n_local), self.n_local,
            dat.device, dat.dtype)

    @property
    def nlevels(self):
        return self.rows.shape[0]

    def __call__(self, b):
        return cuda_triangular.level_sweep(self.schedule, b, self.plain)

    def _level_offsets(self):
        """Offsets of the ``mr`` real segments and the dummy one, per level."""
        mr = self.rows.shape[1]
        if not self.lrow.shape[0]:
            return self.lrow.new_zeros((0, mr + 2))
        return torch.stack([_level_offsets(lr, mr + 1) for lr in self.lrow])

    def plain(self, b):
        """The plain version, on the arrays' device."""
        if self._offsets is None:
            self._offsets = self._level_offsets()
        dt = torch.promote_types(b.dtype, self.dat.dtype)
        b_ext = torch.cat([b.to(dt), b.new_zeros((1,) + tuple(b.shape[1:]), dtype=dt)])
        x = torch.zeros_like(b_ext)
        mr = self.rows.shape[1]
        for l in range(self.nlevels):
            rows = self.rows[l]
            prod = _tail(self.dat[l].to(dt), b.ndim) * x.index_select(0, self.col[l])
            # the dummy segment mr collects the padded entries; dropped
            acc = _segment_sum(prod, self._offsets[l])
            rhs = b_ext.index_select(0, rows) - acc[:mr]
            # x is this call's own buffer: written in place, level by level
            x.index_copy_(0, rows, rhs / _tail(self.diag[l].to(dt), b.ndim))
        return x[: self.n_local]


class LevelScheduledTriangularSolve:
    """Level-scheduled sparse triangular solve (the general-sparsity path).

    Rows are grouped on the host into dependency levels (row i is in level
    ``1 + max(level of its strictly-triangular neighbours)``), and the
    solve runs one data-parallel step per level:

        x[rows_l] = (b[rows_l] - segment_sum(data_l * x[cols_l])) / diag_l

    a gather, a product and a per-row sum in the entries' stored order
    (``_segment_sum``, no atomics: a solve repeats bit for bit) in the
    plain version, :meth:`plain`; on a CUDA device a call launches S2
    (``schedule``, made here on the host), which sums in the same order.
    Unstructured FEM/graph matrices typically have tens of levels; deep
    dependency chains (pure banded) should use the grid sweeps instead, and
    construction refuses above ``max_levels``.  The arrays go to ``device``
    (the default device when None).
    """

    def __init__(self, sp_tri, lower=True, max_levels=1024, device=None, _levels=None):
        n, levels = _levels if _levels is not None else level_arrays(
            sp_tri, lower=lower, max_levels=max_levels)
        device = _device.resolve(device)
        self.n = n
        self.lower = lower
        self.nlevels = len(levels)
        self.dtype = torch.from_numpy(np.zeros(0, levels[0][2].dtype if levels else float)).dtype
        # the plain version's arrays: uploaded here on the CPU, at its first
        # call elsewhere (on the card S2 reads its own copy, ``schedule``)
        self._host, self._levels = (levels, device), None
        if device.type == "cpu":
            self._upload()
        self.schedule = cuda_triangular.LevelSchedule(levels, n, device, self.dtype)

    def _upload(self):
        levels, device = self._host
        self._levels = []
        for rows, d, dat, col, lrow in levels:
            rows, d, dat, col, lrow = (
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (rows, d, dat, col, lrow))
            self._levels.append((rows, d, dat, col, _level_offsets(lrow, rows.numel())))
        self._host = None

    def __call__(self, b):
        return cuda_triangular.level_sweep(self.schedule, b, self.plain)

    def plain(self, b):
        """The plain version, on the arrays' device."""
        if self._levels is None:
            self._upload()
        b = b.to(torch.promote_types(b.dtype, self.dtype))
        x = torch.zeros_like(b)  # this call's own buffer: written in place
        for rows, d, dat, col, offsets in self._levels:
            rhs = b.index_select(0, rows)
            if dat.shape[0]:
                prod = _tail(dat, b.ndim) * x.index_select(0, col)
                rhs = rhs - _segment_sum(prod, offsets)
            x.index_copy_(0, rows, rhs / _tail(d, b.ndim))
        return x
