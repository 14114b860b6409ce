"""Operator layer (L0).

Structural typing for anything applied with ``@`` plus a small zoo of
concrete operators (counterpart of ``krylov_tpu._operators``).  Every
concrete operator holds its tensors on one device (an input that carries
none goes to the package's default device, :mod:`._device`); ``rmatvec``
(adjoint matvec) is provided functionally instead of via cached transposed
copies.  scipy sparse matrices are routed to the sparse operators
(``BSROperator``, ``PETOperator``, ``CSROperator``) as the reference routes
them, through a cache keyed on the matrix, its content and the device.

Every concrete operator also has the reference's pytree children
(``tree_flatten()`` / ``tree_unflatten(aux, children)``), in the
reference's order; :func:`tree_flatten` and :func:`tree_unflatten` walk
nested operators with them, as :mod:`.diffable` does for an operator's
default parameters.
"""

import functools
from typing import Protocol

import numpy as np
import torch

from . import _device

_LEAF = object()  # the tree definition of a leaf


class LinearOperator(Protocol):
    def __matmul__(self, x): ...


class RLinearOperator(LinearOperator, Protocol):
    def rmatvec(self, x): ...


def tree_flatten(op):
    """``(leaves, treedef)`` of an operator, the counterpart of
    ``jax.tree_util.tree_flatten`` over the reference's registered
    operators: an object with a ``tree_flatten()`` method contributes its
    children's leaves in order, ``None`` none, anything else (a tensor) is
    one leaf."""
    if op is None:
        return [], None
    if not hasattr(op, "tree_flatten"):
        return [op], _LEAF
    children, aux = op.tree_flatten()
    leaves, defs = [], []
    for child in children:
        sub, d = tree_flatten(child)
        leaves.extend(sub)
        defs.append(d)
    return leaves, (type(op), aux, tuple(defs))


def tree_unflatten(treedef, leaves):
    """The operator of ``treedef`` (from :func:`tree_flatten`) rebuilt on
    ``leaves``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d is _LEAF:
            return next(it)
        cls, aux, defs = d
        return cls.tree_unflatten(aux, [build(c) for c in defs])

    op = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree definition holds")
    return op


class Identity:
    """No-op operator, default preconditioner.

    dtype is ``uint8`` so it never widens the common dtype of a product.
    """

    dtype = torch.uint8

    def __matmul__(self, x):
        return x

    matvec = __matmul__

    def rmatvec(self, x):
        return x

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls()


class Product:
    """Lazy operator composition, applied right-to-left.

    ``Product(Ml, A, Mr) @ x == Ml @ (A @ (Mr @ x))``.  Its shape runs from
    the first shaped factor's rows to the last one's columns (``Identity``
    has none), and ``rmatvec`` applies the factors' adjoints left to right,
    so a product can be solved and differentiated (:mod:`.diffable`).
    """

    def __init__(self, *operators):
        self.operators = operators
        self.dtype = functools.reduce(
            torch.promote_types, (op.dtype for op in operators)
        )

    @property
    def shape(self):
        shapes = [op.shape for op in self.operators if hasattr(op, "shape")]
        if not shapes:
            raise AttributeError("a product of unshaped operators has no shape")
        return (shapes[0][0], shapes[-1][-1])

    @property
    def device(self):
        for op in self.operators:
            dev = _device.device_of(op)
            if dev is not None:
                return dev
        return None

    def __matmul__(self, x):
        out = x
        for op in self.operators[::-1]:
            out = op @ out
        return out

    matvec = __matmul__

    def ensure_adjoint(self):
        """Build each factor's adjoint that is built on demand, now."""
        for op in self.operators:
            if hasattr(op, "ensure_adjoint"):
                op.ensure_adjoint()
        return self

    def rmatvec(self, x):
        out = x
        for op in self.operators:
            out = op.rmatvec(out)
        return out

    def tree_flatten(self):
        return self.operators, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class MatrixOperator:
    """Dense-matrix operator backed by a tensor.

    The matvec is ``torch.matmul``; the adjoint matvec is ``A^H @ x`` with no
    cached adjoint copy.
    """

    def __init__(self, a):
        self.a = a

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    @property
    def shape(self):
        return tuple(self.a.shape)

    def _promoted(self, x):
        dt = torch.promote_types(self.a.dtype, x.dtype)
        return self.a.to(dt), x.to(dt)

    def __matmul__(self, x):
        a, x = self._promoted(x)
        return torch.matmul(a, x)

    matvec = __matmul__

    def rmatvec(self, x):
        """y = A^H @ x."""
        a, x = self._promoted(x)
        return torch.matmul(a.mH, x)

    def diagonal(self):
        return torch.diagonal(self.a)

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class DiagonalOperator:
    """Diagonal operator ``diag(d)`` — the Jacobi preconditioner shape.

    Elementwise multiply, so it works with any vector shape (flat,
    multi-RHS, grid-shaped).
    """

    def __init__(self, d):
        self.d = d

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    @property
    def shape(self):
        n = self.d.numel()
        return (n, n)

    def _expand(self, d, x):
        # multi-RHS trailing dims broadcast against the diagonal
        return d.reshape(tuple(d.shape) + (1,) * (x.ndim - d.ndim))

    def __matmul__(self, x):
        return self._expand(self.d, x) * x

    matvec = __matmul__

    def rmatvec(self, x):
        return self._expand(self.d.conj(), x) * x

    def diagonal(self):
        return self.d.reshape(-1)

    def tree_flatten(self):
        return (self.d,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def jacobi_preconditioner(A):
    """``M = diag(A)^-1`` as a :class:`DiagonalOperator` (guarding zeros).
    The diagonal of a scipy matrix or numpy array goes to the default
    device."""
    d = A.diagonal() if hasattr(A, "diagonal") else torch.diagonal(A)
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(np.asarray(d), device=_device.resolve(None))
    return DiagonalOperator(torch.where(d != 0, 1.0 / d, 1.0))


class CallableOperatorWrapper:
    """Wraps an arbitrary object that implements ``__matmul__``.

    ``rmatvec`` delegates if available, otherwise applies the object's
    conjugate transpose.  The dtype is the object's own, or float64.
    """

    def __init__(self, obj):
        self._obj = obj
        self._adj = None
        self.shape = getattr(obj, "shape", None)
        dt = getattr(obj, "dtype", None)
        if dt is not None and not isinstance(dt, torch.dtype):
            dt = torch.from_numpy(np.zeros(0, dt)).dtype
        self.dtype = torch.float64 if dt is None else dt

    def __matmul__(self, x):
        return self._obj @ x

    matvec = __matmul__

    def rmatvec(self, x):
        if hasattr(self._obj, "rmatvec"):
            return self._obj.rmatvec(x)
        if self._adj is None:
            self._adj = self._obj.T.conj()
        return self._adj @ x

    def diagonal(self):
        return self._obj.diagonal()


def _pet_device(device):
    """Whether ``device`` (the default device when None) runs the CSR
    kernels: a CUDA device."""
    return _device.resolve(device).type == "cuda"


def _prefer_pet_for_csr(A, device):
    """The port's reading of the reference's rule: large real float32
    matrices go to the CSR kernels on a CUDA device; float64 and complex
    matrices, small ones and CPU runs keep the portable CSROperator (on the
    TPU the reference sends f32 to its PET kernel and keeps f64 parity runs
    on the portable path)."""
    data = getattr(A, "data", np.zeros(0))
    return (
        _pet_device(device)
        and A.nnz >= (1 << 16)
        and not np.iscomplexobj(data)
        and np.dtype(A.dtype) == np.float32
    )


# operators routed from scipy matrices, cached per (matrix, device): the
# conversions are O(nnz) host passes and as_operator runs on every solve.
# The content fingerprint makes an in-place edit of the matrix rebuild, and
# each entry evicts itself when the matrix is garbage collected.
_ROUTE_CACHE = {}


# 64-bit words a row of the matrix view a buffer is summed in
_CHECK_ROW = 1024


def _buffer_checksum(arr):
    """Full-content checksum of one buffer, in two passes at memory speed.

    The buffer's bytes are viewed as a matrix of 64-bit words with
    ``_CHECK_ROW`` columns and summed along both axes with wrap-around: a
    changed word changes its row's sum; two swapped words change two row
    sums or, within one row, two column sums; and so do two swapped elements
    inside one word or across words.  The bytes that do not fill a row
    (under 8 KB) are kept whole.  The sums are torch's (integer sums wrap,
    and run on all of torch's CPU threads: 0.3 ms for 21 MB on 8 cores where
    numpy's take 1.9 ms and ``zlib.crc32`` 9.4 ms); a read-only buffer,
    which torch would not share, takes numpy's."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    nrows = raw.size // (8 * _CHECK_ROW)
    head = nrows * 8 * _CHECK_ROW
    m = raw[:head].view(np.int64).reshape(nrows, _CHECK_ROW)
    if m.flags.writeable:
        t = torch.from_numpy(m)  # shares the buffer: nothing is copied
        sums = (t.sum(dim=1).numpy(), t.sum(dim=0).numpy())
    else:
        sums = (m.sum(axis=1), m.sum(axis=0))
    return (sums[0].tobytes(), sums[1].tobytes(), raw[head:].tobytes())


def _sparse_fingerprint(A):
    """Content fingerprint of a scipy sparse matrix: a checksum of the
    whole of each data and index buffer (:func:`_buffer_checksum`; nothing
    is sampled) with its dtype and length, nnz and shape, so every in-place
    edit flips it."""
    parts = [A.shape, getattr(A, "nnz", None)]
    for name in ("data", "indices", "indptr", "row", "col", "offsets"):
        buf = getattr(A, name, None)
        if buf is None or getattr(buf, "size", 0) == 0:
            continue
        arr = np.asarray(buf)
        if arr.dtype == object:  # lil/dok store ragged object arrays
            continue
        parts.append((name, arr.dtype.str, arr.size, _buffer_checksum(arr)))
    return hash(tuple(parts))


def _route_cached(A, device, build):
    """``build(A)`` memoized on ``(id(A), device)`` and the fingerprint.

    One scipy matrix routed for the CPU and for the card gives two
    operators.  Entries hold only a weak reference to the matrix and
    evict themselves when it is collected, so a loop that builds a fresh
    matrix per time step does not accumulate device buffers.
    """
    import weakref

    fp = _sparse_fingerprint(A)
    key = (id(A), str(_device.resolve(device)))
    hit = _ROUTE_CACHE.get(key)
    if hit is not None and hit[0]() is A and hit[1] == fp:
        return hit[2]
    op = build(A)
    try:
        def _evict(ref, _key=key, _cache=_ROUTE_CACHE):
            # _cache bound as a default: module globals may be gone at
            # interpreter shutdown, when the matrices are finalized
            if _cache is not None:
                ent = _cache.get(_key)
                if ent is not None and ent[0] is ref:
                    del _cache[_key]

        _ROUTE_CACHE[key] = (weakref.ref(A, _evict), fp, op)
    except TypeError:
        pass
    return op


def _route_scipy_sparse(A, device):
    """The sparse operator for a scipy matrix (uncached): block-structured
    matrices to BSR (K12), large real float32 CSR on a CUDA device to the
    CSR kernels (K10/K11), everything else to the portable CSROperator."""
    from .ops.bsr import BSROperator, detect_blocksize
    from .ops.sparse import CSROperator

    bs = detect_blocksize(A)
    if bs is not None:
        return BSROperator.from_scipy(A, blocksize=bs, device=device)
    if _prefer_pet_for_csr(A, device):
        from .ops.cuda_spmv import PETOperator

        # the adjoint is built at the first rmatvec (cg and gmres never
        # need it); a symmetric reorder only for square matrices, and only
        # when the reference's sampled-fill rule says it pays
        reorder = "auto" if A.shape[0] == A.shape[1] else None
        return PETOperator.from_scipy(A, with_rmatvec="lazy", reorder=reorder,
                                      device=device)
    return CSROperator.from_scipy(A, device=device)


class ChebyshevPreconditioner:
    """Polynomial preconditioner ``M r ~= A^{-1} r`` of fixed degree
    (counterpart of ``krylov_tpu.ChebyshevPreconditioner``).

    Runs ``degree`` steps of the Chebyshev semi-iteration (the same
    recurrence as :func:`krylov_tpu_torch.chebyshev`, from a zero initial
    guess) entirely with matvecs: no inner products, hence no reductions
    and no read of the device by the host; an application is ``degree``
    launches of the operator's kernel and a few elementwise ones.  Pairs
    with :func:`krylov_tpu_torch.utils.estimate_spectrum` for the interval.

    The induced polynomial is SPD-preserving on ``[lmin, lmax]`` (it
    approximates 1/lambda positively), so it is a valid CG/MINRES ``M``.
    ``A`` that carries no device goes to ``device`` (the default device
    when None).
    """

    def __init__(self, A, interval, degree=8, device=None):
        self.A = as_operator(A, device)
        self.lmin, self.lmax = float(interval[0]), float(interval[1])
        self.degree = int(degree)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", torch.float64)

    @property
    def device(self):
        return _device.device_of(self.A)

    def __matmul__(self, r):
        d = (self.lmax + self.lmin) / 2.0
        c = (self.lmax - self.lmin) / 2.0
        x = torch.zeros_like(r)
        p = torch.zeros_like(r)
        rk = r
        alpha_prev = 0.0
        for k in range(self.degree):
            factor = 0.25 if k > 1 else 0.5
            beta = 0.0 if k == 0 else factor * (c * alpha_prev) ** 2
            alpha = 1.0 / (d - (beta / alpha_prev if k else 0.0))
            p = rk + beta * p
            x = x + alpha * p
            rk = rk - alpha * (self.A @ p)
            alpha_prev = alpha
        return x

    matvec = __matmul__

    def rmatvec(self, r):
        # polynomial in a Hermitian A is Hermitian
        return self @ r

    def tree_flatten(self):
        return (self.A,), (self.lmin, self.lmax, self.degree)

    @classmethod
    def tree_unflatten(cls, aux, children):
        lmin, lmax, degree = aux
        return cls(children[0], (lmin, lmax), degree)


def as_operator(A, device=None):
    """Normalize anything with ``@`` into an operator this library can drive.

    * tensors -> :class:`MatrixOperator` on the tensor's own device,
    * ndarrays -> :class:`MatrixOperator` on ``device``,
    * objects already exposing ``rmatvec`` are used as-is,
    * scipy sparse matrices -> ``BSROperator``, ``PETOperator`` or
      ``CSROperator`` on ``device``, cached,
    * any other object with ``__matmul__`` is wrapped.

    ``device=None`` is the package's default device: the CUDA device unless
    ``set_default_device`` named another.  Nothing that already lies on a
    device is moved.
    """
    if isinstance(A, (torch.Tensor, np.ndarray)):
        return MatrixOperator(_device.as_tensor(A, device))
    if hasattr(A, "rmatvec"):
        return A
    if hasattr(A, "tocsr"):  # scipy sparse, without importing scipy here
        return _route_cached(A, device, lambda A: _route_scipy_sparse(A, device))
    if not hasattr(A, "__matmul__"):
        raise ValueError(f"Unknown linear operator A = {A}")
    return CallableOperatorWrapper(A)
