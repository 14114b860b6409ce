"""General sparsity on the GPU: the CSR kernels K10 (SpMV) and K11 (SpMM),
their plain PyTorch versions and launch counters, and :class:`PETOperator`.

Counterpart of ``krylov_tpu.ops.pallas_spmv`` (sources in
``krylov_tpu_torch/csrc/spmv.cu``):

* K10 :func:`csr_matvec` — ``y = A x``,
* K11 :func:`csr_matmat` — ``Y = A X`` for ``X`` of shape ``(m, k)``.

The reference's PET page-ELL format, its slot scheduler and its one-hot
selection matmuls exist because Mosaic has one 128-lane gather; Hopper
gathers directly, so the port carries over the product and keeps plain CSR:
int32 row pointers and columns, float32 or bfloat16 values, float32 ``x``
and float32 sums.  :class:`PETOperator` keeps the reference's name and its
``from_scipy`` contract (adjoint, bf16 values, symmetric reordering).

A wrapper runs its plain version only when its tensors lie on the CPU; on
a CUDA device it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``; the plain versions count nothing.  A launch captured into the
``while_loop`` driver's CUDA graph counts once for each step that a replay
runs (:func:`krylov_tpu_torch._graphs.count`).  The kernels have no
backward: on the card a wrapper raises a ``TypeError`` for an input that
requires a gradient in grad mode (autograd differentiates the plain
versions on the CPU).
"""

import ctypes
import functools
import weakref

import numpy as np
import torch

from .. import _device
from .._graphs import count as _count
from .cuda_stencil import _check, _on_cpu, _ptr, _refuse_grad, _require, _stream
from .sparse import _segment_sum

LAUNCHES = {"csr_matvec": 0, "csr_matmat": 0}

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.krylov_csr_spmv.argtypes = [i32, i32, i32] + [vp] * 6 + [i32, vp]
    lib.krylov_csr_spmv.restype = i32
    lib.krylov_csr_spmm.argtypes = [i32, i32, i32] + [vp] * 6 + [i32, i32, vp]
    lib.krylov_csr_spmm.restype = i32
    lib.krylov_error_string.argtypes = [i32]
    lib.krylov_error_string.restype = ctypes.c_char_p
    return lib


# entries a block of K10 or K11 keeps in shared memory (csrc/spmv.cu builds
# 1024, 2048, 4096 and 8192)
RUN_CAPACITY = 2048


def csr_runs(indptr, capacity=RUN_CAPACITY):
    """The row partition of K10 and K11, made once per matrix on the host:
    the first row of each run and, last, the number of rows, as an int32
    array.  A run is
    a stretch of whole rows that a block streams at once: it takes rows
    while they hold at most ``capacity - 3`` stored entries together (the
    kernel rounds a run's first entry down to a 16-byte boundary) and
    number at most ``capacity``; a row longer than that is a run of its
    own.  ``indptr``: the ``n + 1`` row pointers, a numpy array or a CPU
    tensor."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    limit = capacity - 3
    starts = [0]
    row = 0
    while row < n:
        # the last row boundary within the limit, at least one row on
        nxt = int(np.searchsorted(indptr, indptr[row] + limit, side="right")) - 1
        row = min(max(nxt, row + 1), row + capacity, n)
        starts.append(row)
    return np.asarray(starts, dtype=np.int32)


# runs made for bare csr_matvec calls, per indptr tensor: keyed on its
# storage pointer, device, length and version counter (an in-place edit
# bumps it), each entry evicted when its tensor is collected
_RUNS_CACHE = {}


def cached_runs(indptr):
    """:func:`csr_runs` of ``indptr`` at :data:`RUN_CAPACITY` as an int32
    tensor on ``indptr``'s device, made once per ``indptr`` tensor: the
    first call copies the row pointers to the host and cuts the runs, a
    later call with the same unedited tensor copies nothing."""
    key = (indptr.data_ptr(), str(indptr.device), indptr.numel(), indptr._version)
    hit = _RUNS_CACHE.get(key)
    if hit is not None:
        return hit[1]
    runs = torch.from_numpy(csr_runs(indptr.cpu().numpy())).to(indptr.device)

    def _evict(ref, _key=key, _cache=_RUNS_CACHE):
        ent = _cache.get(_key)
        if ent is not None and ent[0] is ref:
            del _cache[_key]

    _RUNS_CACHE[key] = (weakref.ref(indptr, _evict), runs)
    return runs


# ---------------------------------------------------------------------------
# K10 / K11 and their plain versions
# ---------------------------------------------------------------------------


def csr_matvec_plain(indptr, indices, data, x):
    """Plain version of K10 and K11: gather, products, and a segment sum
    per row (``CSROperator``'s, in row order), in the promoted type of
    ``data`` and ``x`` and at least float32 (float32 for the kernels'
    float32 or bfloat16 values and float32 ``x``).  ``x`` is ``(m,)`` or
    ``(m, k)``; returns ``(n,)`` or ``(n, k)``."""
    acc = torch.promote_types(torch.promote_types(data.dtype, x.dtype), torch.float32)
    prod = data.to(acc).reshape((-1,) + (1,) * (x.ndim - 1)) * x.to(acc).index_select(
        0, indices.long())
    return _segment_sum(prod, indptr.long())


def _csr_checks(indptr, indices, data, x, ndim):
    _require(data.dtype in _VALUE_CODES, f"no CSR kernel for values of {data.dtype}")
    _require(indptr.dtype == torch.int32 and indices.dtype == torch.int32,
             "indptr and indices must be int32")
    _require(x.dtype == torch.float32 and x.ndim == ndim and x.is_contiguous(),
             f"x must be a contiguous {ndim}-D float32 tensor")
    for t in (indptr, indices, data):
        _require(t.ndim == 1 and t.is_contiguous(), "CSR arrays must be contiguous 1-D")
    _require(indices.numel() == data.numel(), "indices and data differ in length")


def _runs_of(indptr, runs, x):
    if runs is None:
        runs = cached_runs(indptr)
    _require(runs.dtype == torch.int32 and runs.ndim == 1 and runs.is_contiguous()
             and runs.device == x.device and runs.numel() >= 2,
             "runs must be csr_runs(indptr) as a contiguous int32 tensor on x's device")
    return runs


def csr_matvec(indptr, indices, data, x, runs=None):
    """K10: ``y = A x`` for CSR ``(indptr, indices, data)``; ``x`` float32
    of length ``m``, ``y`` float32 of length ``n = len(indptr) - 1``.
    ``runs``: the row partition :func:`csr_runs` makes of ``indptr`` at
    :data:`RUN_CAPACITY`, as an int32 tensor on ``x``'s device; an operator
    makes it once.  Without it the runs come from :func:`cached_runs`: the
    first call with an ``indptr`` tensor copies it to the host and waits for
    the device, later calls with the same tensor copy nothing."""
    if _on_cpu(indptr, indices, data, x):
        return csr_matvec_plain(indptr, indices, data, x)
    _refuse_grad("csr_matvec", data, x)
    _csr_checks(indptr, indices, data, x, 1)
    n = indptr.numel() - 1
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    runs = _runs_of(indptr, runs, x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.krylov_csr_spmv(
            _VALUE_CODES[data.dtype], RUN_CAPACITY, runs.numel() - 1, _ptr(runs), _ptr(indptr),
            _ptr(indices), _ptr(data), _ptr(x), _ptr(y), data.numel(), _stream(x))
    _check(lib, err, "csr_matvec")
    _count(LAUNCHES, "csr_matvec")
    return y


def csr_matmat(indptr, indices, data, X, runs=None):
    """K11: ``Y = A X`` for ``X`` float32 of shape ``(m, k)``, any ``k``
    (row-major); ``Y`` float32 ``(n, k)``.  ``runs``: K10's row partition,
    which K11 takes too (see :func:`csr_matvec`); one launch reads the
    matrix once for every 32 columns of ``X``."""
    if _on_cpu(indptr, indices, data, X):
        return csr_matvec_plain(indptr, indices, data, X)
    _refuse_grad("csr_matmat", data, X)
    _csr_checks(indptr, indices, data, X, 2)
    n, k = indptr.numel() - 1, X.shape[1]
    Y = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return Y
    runs = _runs_of(indptr, runs, X)
    lib = _lib()
    with torch.cuda.device(X.device):
        err = lib.krylov_csr_spmm(
            _VALUE_CODES[data.dtype], RUN_CAPACITY, runs.numel() - 1, _ptr(runs), _ptr(indptr),
            _ptr(indices), _ptr(data), _ptr(X), _ptr(Y), data.numel(), k, _stream(X))
    _check(lib, err, "csr_matmat")
    _count(LAUNCHES, "csr_matmat")
    return Y


# ---------------------------------------------------------------------------
# symmetric reordering (host numpy / scipy, as the reference)
# ---------------------------------------------------------------------------


def rcm_permutation(sp):
    """Symmetric reverse-Cuthill-McKee ordering of ``sp``'s pattern: the
    permutation ``perm`` that (greedily) minimizes the bandwidth of
    ``sp[perm][:, perm]``."""
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = scipy.sparse.csr_matrix(sp)
    pattern = (csr + csr.T).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(pattern, symmetric_mode=True), dtype=np.int64
    )


def invert_permutation(perm):
    """Inverse of an index permutation: ``inv[perm[i]] = i``."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def resolve_reorder(sp, reorder, metric="fill"):
    """A reorder spec as a permutation, or None to keep the order.

    ``"rcm"`` always reorders; ``"auto"`` reorders only when it pays: by
    the reference's sampled PET fill for ``metric="fill"`` (below 0.15, and
    RCM at least doubles it), so the port makes the reference's choice, or
    by matrix bandwidth for ``metric="bandwidth"`` (RCM at least halves
    it: the halo a row slab exchanges); an index array is used as given.
    Rectangular matrices raise up front.
    """
    import scipy.sparse

    if reorder is None:
        return None
    if isinstance(reorder, str) and sp.shape[0] != sp.shape[1]:
        raise ValueError("reorder= needs a square matrix (symmetric permutation)")
    if isinstance(reorder, str):
        if reorder == "rcm":
            return rcm_permutation(sp)
        if reorder != "auto":
            raise ValueError(f"unknown reorder mode {reorder!r}")
        csr = scipy.sparse.csr_matrix(sp)
        if metric == "fill":
            f0 = estimate_pet_fill(csr)
            if f0 >= 0.15:
                return None
            cand = rcm_permutation(csr)
            return cand if estimate_pet_fill(csr, cand) >= 2.0 * f0 else None
        if metric != "bandwidth":
            raise ValueError(f"unknown reorder metric {metric!r}")
        rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
        if rows.size == 0:
            return None
        bw0 = int(np.abs(csr.indices - rows).max())
        cand = rcm_permutation(csr)
        inv = invert_permutation(cand)
        bw1 = int(np.abs(inv[csr.indices] - inv[rows]).max())
        return cand if 2 * bw1 <= bw0 else None
    perm = np.asarray(reorder, np.int64)
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("reorder= needs a square matrix (symmetric permutation)")
    return perm


def estimate_pet_fill(sp, perm=None, n_sample=64, seed=0):
    """The reference's sampled PET fill of (a symmetric reordering of)
    ``sp``: true entries over 128-lane slots on a random sample of 128-row
    subgroups.  The port streams plain CSR; the estimate is kept so that
    ``reorder="auto"`` makes the reference's choice."""
    import scipy.sparse

    csr = scipy.sparse.csr_matrix(sp)
    n = csr.shape[0]
    nsg = max(1, -(-n // 128))
    rng = np.random.default_rng(seed)
    sgs = (
        np.arange(nsg)
        if nsg <= n_sample
        else np.sort(rng.choice(nsg, n_sample, replace=False))
    )
    indptr = csr.indptr.astype(np.int64)
    indices = csr.indices.astype(np.int64)
    inv = None
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
    slots = 0
    nnz_s = 0
    for sg in sgs:
        r0, r1 = sg * 128, min((sg + 1) * 128, n)
        rows = np.arange(r0, r1)
        src = perm[rows] if perm is not None else rows
        cnt = indptr[src + 1] - indptr[src]
        if cnt.sum() == 0:
            continue
        lanes = np.repeat(rows - r0, cnt)
        cols = np.concatenate([indices[indptr[s]: indptr[s + 1]] for s in src])
        if inv is not None:
            cols = inv[cols]
        key = (cols >> 7) * 128 + lanes
        uk, c = np.unique(key, return_counts=True)
        pg = uk // 128
        order = np.argsort(pg, kind="stable")
        pgs, cs = pg[order], c[order]
        starts = np.flatnonzero(np.r_[True, pgs[1:] != pgs[:-1]])
        slots += int(np.maximum.reduceat(cs, starts).sum())
        nnz_s += int(cnt.sum())
    return nnz_s / max(1, slots * 128)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


def _value_dtype(data_dtype):
    """float32 for None; bfloat16 for a torch, numpy (ml_dtypes) or JAX
    bfloat16 or the string "bfloat16"."""
    if data_dtype is None or data_dtype is torch.float32:
        return torch.float32
    if data_dtype is torch.bfloat16 or "bfloat16" in str(getattr(data_dtype, "__name__", data_dtype)):
        return torch.bfloat16
    raise ValueError(f"data_dtype must be None or bfloat16, not {data_dtype!r}")


class _CSR:
    """One CSR matrix on a device: int32 row pointers and columns, values of
    the operator's value dtype, and the row partition of K10 and K11."""

    def __init__(self, sp, value_dtype, device):
        import scipy.sparse

        if (
            scipy.sparse.issparse(sp) and sp.format == "csr"
            and sp.dtype == np.float32 and sp.has_canonical_format
        ):
            csr = sp  # already canonical f32: skip the O(nnz) copy
        else:
            csr = scipy.sparse.csr_matrix(sp).astype(np.float32)
            csr.sum_duplicates()  # canonical: sorted columns, no duplicates
        if csr.nnz >= 2**31 - 2**14:  # K10 indexes up to a run past the end in int32
            raise ValueError("the CSR kernels take fewer than 2**31 - 2**14 entries")
        self.shape = csr.shape
        self.nnz = int(csr.nnz)
        self.indptr = torch.from_numpy(csr.indptr.astype(np.int32)).to(device)
        self.indices = torch.from_numpy(csr.indices.astype(np.int32)).to(device)
        self.data = torch.from_numpy(np.ascontiguousarray(csr.data)).to(device, value_dtype)
        self.runs = torch.from_numpy(csr_runs(csr.indptr)).to(device)

    def apply(self, x):
        if x.ndim == 1:
            return csr_matvec(self.indptr, self.indices, self.data, x, self.runs)
        return csr_matmat(self.indptr, self.indices, self.data, x, self.runs)

    def tree_flatten(self):
        return (self.indptr, self.indices, self.data, self.runs), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        self = object.__new__(cls)
        self.shape, self.nnz = aux
        self.indptr, self.indices, self.data, self.runs = children
        return self


class PETOperator:
    """General-sparsity operator on the CSR kernels K10 and K11.

    The reference's name and ``from_scipy`` contract, built once on the host
    from a scipy matrix: values in float32 (or bfloat16 with
    ``data_dtype``), products and sums in float32, ``x`` cast to float32,
    output float32.  ``rmatvec`` runs K10 on the CSR of ``A^H``.  With a
    symmetric ``reorder`` the operator holds ``B = A[perm][:, perm]`` and
    wraps the kernel in two ``index_select`` gathers, so callers see
    user-order semantics.

    Its leaves (``tree_flatten``) are the CSR tensors of the matrix and of
    its adjoint, the diagonal and the permutations: format arrays that the
    kernels do not differentiate, so ``params_differentiable`` is False
    and :func:`krylov_tpu_torch.diffable.solve` gives gradients through
    ``b`` only, as the reference does for its PET kernel.  Flattening does
    not build a lazy adjoint: call :meth:`ensure_adjoint` first.
    """

    params_differentiable = False

    def __init__(self, csr, csr_t, diag, shape, sp=None, value_dtype=torch.float32,
                 perm=None, inv_perm=None):
        self._csr = csr
        self._csr_t = csr_t
        self._diag = diag
        self.shape = tuple(shape)
        # host handle for a lazy adjoint: a zero-argument callable returning
        # the scipy matrix, or None once it is gone; a route-cached operator
        # must not keep the user's matrix alive (the cache evicts by weakref)
        self._sp = sp
        self._value_dtype = value_dtype
        self._perm = perm
        self._inv_perm = inv_perm

    @classmethod
    def from_scipy(cls, sp, with_rmatvec=True, data_dtype=None, reorder=None,
                   device=None):
        """``with_rmatvec``: True builds the adjoint now, ``"lazy"`` at the
        first ``rmatvec`` (through a weak handle to the scipy matrix: keep
        it alive until then, or use True), False never.

        ``reorder``: ``"rcm"``, ``"auto"`` (the reference's sampled-fill
        rule, :func:`resolve_reorder`), an index array, or None.
        """
        import scipy.sparse

        device = _device.resolve(device)
        value_dtype = _value_dtype(data_dtype)
        perm_np = resolve_reorder(sp, reorder)
        sp_build = sp
        perm = inv_perm = None
        if perm_np is not None:
            csr = scipy.sparse.csr_matrix(sp)
            sp_build = csr[perm_np][:, perm_np].tocsr()
            perm = torch.from_numpy(np.asarray(perm_np, np.int64)).to(device)
            inv_perm = torch.from_numpy(invert_permutation(perm_np).astype(np.int64)).to(device)
        csr = _CSR(sp_build, value_dtype, device)
        csr_t = (
            _CSR(sp_build.T.conj().tocsr(), value_dtype, device)
            if with_rmatvec is True else None
        )
        # diagonal in user order (independent of the permutation)
        diag = torch.from_numpy(
            np.asarray(sp.tocsr().diagonal(), dtype=np.float32)
        ).to(device)
        handle = None
        if with_rmatvec == "lazy":
            if sp_build is sp:
                import weakref

                handle = weakref.ref(sp_build)
            else:
                handle = (lambda _ref=sp_build: _ref)  # our own permuted copy
        return cls(csr, csr_t, diag, sp.shape, sp=handle, value_dtype=value_dtype,
                   perm=perm, inv_perm=inv_perm)

    @property
    def dtype(self):
        return self._value_dtype

    @property
    def device(self):
        return self._diag.device

    @property
    def nnz(self):
        return self._csr.nnz

    @property
    def fill(self):
        """True entries over the entries the kernel streams: 1.0, CSR has no
        padding (the reference's page-ELL fill is below 1)."""
        return 1.0

    def _apply(self, csr, x):
        # csr is the matrix's or its adjoint's: x has as many rows as it has columns
        if x.ndim not in (1, 2) or x.shape[0] != csr.shape[1]:
            raise ValueError(f"x of shape {tuple(x.shape)} does not match the "
                             f"{'operator' if csr is self._csr else 'adjoint'}'s {csr.shape}")
        x = x.to(torch.float32)
        if self._perm is not None:
            x = x.index_select(0, self._perm)
        y = csr.apply(x.contiguous())
        if self._inv_perm is not None:
            y = y.index_select(0, self._inv_perm)
        return y

    def __matmul__(self, x):
        return self._apply(self._csr, x)

    matvec = __matmul__

    def ensure_adjoint(self):
        """Build the adjoint's CSR now (host side, once), from the lazy
        handle."""
        if self._csr_t is None and self._sp is not None:
            spb = self._sp()
            if spb is not None:
                self._csr_t = _CSR(spb.T.conj().tocsr(), self._value_dtype, self.device)
        return self

    def rmatvec(self, x):
        self.ensure_adjoint()
        if self._csr_t is None:
            raise ValueError(
                "PETOperator has no adjoint here: construct with "
                "with_rmatvec=True, or call .ensure_adjoint() before "
                "passing a with_rmatvec='lazy' operator across a "
                "jit/pytree boundary (the host scipy handle does not "
                "survive flattening, nor garbage collection of the "
                "source matrix)"
            )
        return self._apply(self._csr_t, x)

    def diagonal(self):
        return self._diag

    def tree_flatten(self):
        return ((self._csr, self._csr_t, self._diag, self._perm, self._inv_perm),
                (self.shape, self._value_dtype))

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, value_dtype = aux
        csr, csr_t, diag, perm, inv_perm = children
        return cls(csr, csr_t, diag, shape, value_dtype=value_dtype, perm=perm,
                   inv_perm=inv_perm)
