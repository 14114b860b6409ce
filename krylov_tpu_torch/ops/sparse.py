"""Portable sparse operators (counterpart of ``krylov_tpu.ops.sparse``).

* :class:`CSROperator` — general sparsity in plain torch, any dtype: the
  matvec is a gather and a segment sum per row, the adjoint the same on a
  column-grouped copy built once, so both sum in one fixed order on every
  device (no scatter, no float atomics).  On a CUDA device large real
  float32 matrices go to :class:`~krylov_tpu_torch.ops.cuda_spmv.PETOperator`
  instead (``as_operator``'s routing, as the reference's).
* :class:`DiaOperator` — diagonal storage: a sum of shifted scaled reads.

Row pointers, columns and ``row_ids`` are int64 tensors (torch's index
type; the reference keeps int32).
"""

import numpy as np
import torch

from .. import _device


def _segment_sum(prod, indptr):
    """Sum of ``prod``'s rows per CSR row, each row's entries in ascending
    order (complex via its real view, which ``segment_reduce`` takes).  A
    vector is summed as one column: on a CUDA device ``segment_reduce``
    gives each segment of a vector a thread block (CUB's segmented
    reduction), each of a column a thread, which on short rows is many
    times faster (``chip_smoke.py`` phase 6d times both)."""
    if prod.is_complex():
        out = torch.segment_reduce(torch.view_as_real(prod), "sum", offsets=indptr, axis=0)
        return torch.view_as_complex(out.contiguous())
    if prod.ndim == 1:
        return torch.segment_reduce(prod[:, None], "sum", offsets=indptr, axis=0)[:, 0]
    return torch.segment_reduce(prod, "sum", offsets=indptr, axis=0)


def _indptr_of_rows(rows, n, device):
    counts = torch.bincount(rows, minlength=n)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.cumsum(counts, 0)])


class CSROperator:
    """Compressed-sparse-row operator.

    ``data (nnz,), indices (nnz,), indptr (N+1,)`` plus the CSR-to-COO row
    map ``row_ids (nnz,)``:

        A  @ x = segment_sum(data * x[indices], indptr)
        A^H @ x = the same on A^H's column-grouped copy (:meth:`rmatvec`)
    """

    def __init__(self, data, indices, indptr, shape, row_ids=None):
        self.data = data
        self.indices = indices.long()
        self.indptr = indptr.long()
        self.shape = tuple(int(s) for s in shape)
        if row_ids is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            row_ids = torch.repeat_interleave(
                torch.arange(self.shape[0], device=data.device), counts)
        self.row_ids = row_ids.long()
        self._adjoint = None  # A^H's column-grouped copy, once built

    @classmethod
    def from_scipy(cls, A, device=None):
        device = _device.resolve(device)
        csr = A.tocsr()
        csr.sort_indices()
        rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(t(csr.data), t(csr.indices.astype(np.int64)),
                   t(csr.indptr.astype(np.int64)), csr.shape, row_ids=t(rows))

    @classmethod
    def from_dense(cls, A, device=None):
        device = _device.resolve(device)
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        indptr = np.zeros(A.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(t(A[rows, cols]), t(cols.astype(np.int64)), t(indptr), A.shape,
                   row_ids=t(rows.astype(np.int64)))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return self.data.shape[0]

    def _cast(self, x):
        dt = torch.promote_types(self.data.dtype, x.dtype)
        return self.data.to(dt), x.to(dt)

    def __matmul__(self, x):
        data, x = self._cast(x)
        prod = data.reshape((-1,) + (1,) * (x.ndim - 1)) * x.index_select(0, self.indices)
        return _segment_sum(prod, self.indptr)

    matvec = __matmul__

    def ensure_adjoint(self):
        """Build ``A^H``'s column-grouped copy now (once; it reads the
        device, so outside any CUDA-graph capture) and keep it on the
        operator for :meth:`rmatvec`."""
        if self._adjoint is None:
            with torch.no_grad():
                self._adjoint = self.adjoint()
        return self

    def rmatvec(self, x):
        """``A^H x``: the matvec of the copy :meth:`ensure_adjoint` keeps, a
        gather and a segment sum over each column's entries in ascending
        row order, so it repeats bit for bit on every device.  The copy
        takes ``nnz`` values, two ``nnz`` int64 index arrays and ``shape[1]
        + 1`` int64 pointers.  Where autograd tracks ``data``, a copy is
        built for the call, so the product stays differentiable."""
        if torch.is_grad_enabled() and self.data.requires_grad:
            return self.adjoint() @ x
        return self.ensure_adjoint()._adjoint @ x

    def adjoint(self):
        """``A^H`` as a CSR operator of its own, ``shape[1]`` rows, regrouped
        by column on the device (each column's entries in ascending row
        order; an empty column is an empty row, an exact 0), complex data
        conjugated: its matvec is ``A^H x`` in one fixed order."""
        order = torch.argsort(self.indices, stable=True)
        cols = self.indices.index_select(0, order)
        data = self.data.index_select(0, order)
        if data.is_complex():
            data = data.conj_physical()
        return CSROperator(data, self.row_ids.index_select(0, order),
                           _indptr_of_rows(cols, self.shape[1], self.device),
                           (self.shape[1], self.shape[0]), row_ids=cols)

    def diagonal(self):
        on_diag = self.indices == self.row_ids
        return _segment_sum(torch.where(on_diag, self.data, 0), self.indptr)

    def todense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row_ids, self.indices), self.data, accumulate=True)

    def tril(self, keep_diagonal=True):
        """Lower-triangular part as a new CSROperator (for GS/SOR sweeps)."""
        mask = (self.indices <= self.row_ids if keep_diagonal
                else self.indices < self.row_ids)
        return self._masked(mask)

    def triu(self, keep_diagonal=True):
        mask = (self.indices >= self.row_ids if keep_diagonal
                else self.indices > self.row_ids)
        return self._masked(mask)

    def _masked(self, mask):
        rows = self.row_ids[mask]
        return CSROperator(self.data[mask], self.indices[mask],
                           _indptr_of_rows(rows, self.shape[0], self.device),
                           self.shape, row_ids=rows)

    def with_diagonal(self, d):
        """A copy whose diagonal entries are replaced by ``d`` (SOR)."""
        on_diag = self.indices == self.row_ids
        d = torch.as_tensor(d, device=self.device)
        new_data = torch.where(on_diag, d.index_select(0, self.row_ids), self.data)
        return CSROperator(new_data, self.indices, self.indptr, self.shape, self.row_ids)

    def tree_flatten(self):
        return (self.data, self.indices, self.indptr, self.row_ids), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        data, indices, indptr, row_ids = children
        return cls(data, indices, indptr, shape, row_ids)


class DiaOperator:
    """Diagonal-storage (banded) operator, scipy ``spdiags`` convention:
    ``diags (ndiag, N)``, static ``offsets``; row i reads
    ``diags[d, i + offset] * x[i + offset]``."""

    def __init__(self, diags, offsets, shape):
        self.diags = diags
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)

    @classmethod
    def from_scipy(cls, A, device=None):
        device = _device.resolve(device)
        dia = A.todia()
        return cls(torch.from_numpy(np.ascontiguousarray(dia.data)).to(device),
                   tuple(int(o) for o in dia.offsets), dia.shape)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def nnz(self):
        n = self.shape[0]
        return sum(n - abs(o) for o in self.offsets)

    def __matmul__(self, x):
        n = self.shape[0]
        y = torch.zeros(x.shape, dtype=torch.promote_types(self.dtype, x.dtype),
                        device=x.device)
        tail = (1,) * (x.ndim - 1)
        for d, off in enumerate(self.offsets):
            diag = self.diags[d]
            if off >= 0:
                y[: n - off] += diag[off:].reshape((n - off,) + tail) * x[off:]
            else:
                y[-off:] += diag[: n + off].reshape((n + off,) + tail) * x[: n + off]
        return y

    matvec = __matmul__

    def rmatvec(self, x):
        n = self.shape[0]
        y = torch.zeros(x.shape, dtype=torch.promote_types(self.dtype, x.dtype),
                        device=x.device)
        tail = (1,) * (x.ndim - 1)
        for d, off in enumerate(self.offsets):
            diag = self.diags[d].conj()
            if off >= 0:
                y[off:] += diag[off:].reshape((n - off,) + tail) * x[: n - off]
            else:
                y[: n + off] += diag[: n + off].reshape((n + off,) + tail) * x[-off:]
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)

    def tocsr(self):
        import scipy.sparse

        sp = scipy.sparse.dia_matrix(
            (self.diags.cpu().numpy(), np.asarray(self.offsets)), shape=self.shape
        )
        return CSROperator.from_scipy(sp, device=self.device)

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape = aux
        return cls(children[0], offsets, shape)
