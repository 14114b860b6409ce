"""General sparsity in krylov_tpu_torch, held to krylov_tpu on the CPU.

The portable ``CSROperator``/``DiaOperator``, the plain versions of the CSR
kernels K10/K11 (``cuda_spmv.csr_matvec``/``csr_matmat``) and of the BSR
kernel K12 (``cuda_bsr.bsr_spmm``), ``PETOperator``'s ``from_scipy``
contract (bf16 values, reordering, the three adjoint modes), ``BSROperator``
with ``detect_blocksize``, ``as_operator``'s scipy routing and its cache,
``tocsr`` of the stencil operators, ``convert.from_reference`` for the
sparse formats and ``multi_solve_triangular``.  The reference's Pallas
kernels run in interpret mode, as its own tests run them on the CPU.
Inputs are made from numpy seeds.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import _operators as j_ops
from krylov_tpu.ops import bsr as j_bsr
from krylov_tpu.ops import pallas_bsr as j_pallas_bsr
from krylov_tpu.ops import pallas_spmv as j_spmv
from krylov_tpu.ops import sparse as j_sparse
from krylov_tpu.ops import stencil as j_stencil
from krylov_tpu.ops import triangular as j_tri
from krylov_tpu_torch import _operators as t_ops
from krylov_tpu_torch import convert
from krylov_tpu_torch.ops import bsr as t_bsr
from krylov_tpu_torch.ops import cuda_bsr, cuda_spmv
from krylov_tpu_torch.ops import sparse as t_sparse
from krylov_tpu_torch.ops import stencil as t_stencil
from krylov_tpu_torch.ops.triangular import multi_solve_triangular

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


def _irregular(n, span, dmax, seed=0, empty_rows=True):
    """The reference tests' irregular matrix: row degrees 0 (or 5) .. dmax,
    columns within +-span of the diagonal."""
    rng = np.random.default_rng(seed)
    row_nnz = rng.integers(0 if empty_rows else 5, dmax, n)
    indptr = np.r_[0, np.cumsum(row_nnz)]
    r = np.repeat(np.arange(n), row_nnz)
    c = np.clip(r + rng.integers(-span, span, r.size), 0, n - 1).astype(np.int32)
    return scipy.sparse.csr_matrix((rng.standard_normal(r.size), c, indptr), shape=(n, n))


CASES = {
    "tridiag": scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(300, 300),
                                  format="csr"),
    "rect": scipy.sparse.random(257, 391, density=0.05, random_state=1, format="csr"),
    "irregular": _irregular(1000, 200, 30),
    "empty": scipy.sparse.csr_matrix((130, 130)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _csr_arrays(sp, value_dtype=torch.float64):
    return (_t(sp.indptr.astype(np.int32)), _t(sp.indices.astype(np.int32)),
            _t(sp.data).to(value_dtype))


# ---------------------------------------------------------------------------
# K10 / K11 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_k10_k11_plain_match_scipy_f64(name):
    sp = CASES[name]
    indptr, indices, data = _csr_arrays(sp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(sp.shape[1])
    got = cuda_spmv.csr_matvec(indptr, indices, data, _t(x))
    assert got.dtype == torch.float64 and got.shape == (sp.shape[0],)
    np.testing.assert_allclose(got.numpy(), sp @ x, rtol=0,
                               atol=1e-12 * (1 + np.abs(sp @ x).max(initial=0)))
    X = rng.standard_normal((sp.shape[1], 3))
    got = cuda_spmv.csr_matmat(indptr, indices, data, _t(X))
    np.testing.assert_allclose(got.numpy(), sp @ X, rtol=0,
                               atol=1e-12 * (1 + np.abs(sp @ X).max(initial=0)))


@pytest.mark.parametrize("name,k", [("irregular", 1), ("irregular", 3), ("rect", 2)])
def test_k10_k11_plain_match_reference_kernel(name, k):
    """f32 values and x through the plain versions against the reference's
    PET kernel (interpret mode): 1e-5 of the output's scale."""
    sp = CASES[name].astype(np.float32)
    ref = j_spmv.PETOperator.from_scipy(sp, interpret=True, with_rmatvec=False)
    indptr, indices, data = _csr_arrays(sp, torch.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((sp.shape[1], k) if k > 1 else sp.shape[1]).astype(np.float32)
    fn = cuda_spmv.csr_matmat if k > 1 else cuda_spmv.csr_matvec
    got = fn(indptr, indices, data, _t(x))
    want = np.asarray(ref @ jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# K10's row partition (host side) and a product that follows it
# ---------------------------------------------------------------------------


def _dense_row(n=700, long=5000, seed=4):
    """Short rows around one row of ``long`` entries: longer than a run."""
    rng = np.random.default_rng(seed)
    sp = _irregular(n, 50, 9, seed=seed, empty_rows=False).tolil()
    wide = scipy.sparse.lil_matrix((n, long))
    wide[:, :n] = sp
    wide[n // 2] = rng.standard_normal(long)
    return wide.tocsr()


RUN_CASES = {
    **CASES,
    "one row": scipy.sparse.csr_matrix(np.arange(1.0, 8.0)[None, :]),
    "dense row": _dense_row(),
    "empty rows": _irregular(3000, 100, 4, seed=5),  # degrees 0..3, a third of the rows empty
    # the two bench-like patterns at small size: 5 to 49 entries a row within
    # +-512 columns, and the 5-point shifted Poisson
    "bench irregular": _irregular(4000, 512, 50, seed=7, empty_rows=False),
    "bench poisson": scipy.sparse.diags([-1.0, -1.0, 4.5, -1.0, -1.0], [-48, -1, 0, 1, 48],
                                        shape=(48 * 48, 48 * 48), format="csr"),
}


@pytest.mark.parametrize("capacity", [1024, 2048])
@pytest.mark.parametrize("name", list(RUN_CASES))
def test_csr_runs_partition_the_rows(name, capacity):
    """The runs cover every row once, in order; a run holds at most
    ``capacity - 3`` entries and ``capacity`` rows unless it is one long
    row; and no two neighbouring runs could have been one (greedy)."""
    indptr = RUN_CASES[name].indptr
    n = len(indptr) - 1
    runs = cuda_spmv.csr_runs(indptr, capacity)
    assert runs.dtype == np.int32 and runs[0] == 0 and runs[-1] == n
    rows, entries = np.diff(runs), np.diff(indptr[runs].astype(np.int64))
    assert (rows > 0).all() or n == 0
    assert (rows <= capacity).all()
    assert ((entries <= capacity - 3) | (rows == 1)).all()
    merged_rows, merged_entries = rows[:-1] + rows[1:], entries[:-1] + entries[1:]
    assert ((merged_entries > capacity - 3) | (merged_rows > capacity)
            | (rows[:-1] == 1) & (entries[:-1] > capacity - 3)).all()
    if name == "dense row":
        assert (entries > capacity - 3).sum() == 1
    assert np.array_equal(runs, cuda_spmv.csr_runs(_t(indptr), capacity))  # a CPU tensor too


def _matvec_by_runs(sp, x, capacity, lane_entries=4):
    """K10 as csrc/spmv.cu computes it, on the host in float32: per run the
    products entry by entry, then each row summed by ``G`` lanes taking its
    entries in turn and meeting in a shuffle tree (``G`` from the run's mean
    row length, 1 for short rows); a run of one row summed by 256 threads
    and a block-wide tree."""
    indptr, indices = sp.indptr.astype(np.int64), sp.indices
    data, x = sp.data.astype(np.float32), x.astype(np.float32)
    y = np.full(sp.shape[0], np.nan, np.float32)
    runs = cuda_spmv.csr_runs(indptr, capacity)

    def tree(parts):  # shuffle-down tree over a power-of-two number of lanes
        parts = list(parts)
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [np.float32(parts[k] + parts[k + half]) for k in range(half)]
        return parts[0]

    def lanes_sum(p, G):
        parts = []
        for lane in range(G):
            acc = np.float32(0)
            for v in p[lane::G]:
                acc = np.float32(acc + v)
            parts.append(acc)
        return tree(parts)

    for r0, r1 in zip(runs[:-1], runs[1:]):
        e0, e1 = indptr[r0], indptr[r1]
        prod = data[e0:e1] * x[indices[e0:e1]]
        if r1 - r0 == 1:
            per_warp = [tree(lanes_sum(prod[w * 32 + t::256], 1) for t in range(32))
                        for w in range(8)]
            y[r0] = tree(per_warp + [np.float32(0)] * 24)
            continue
        mean = (e1 - e0) // (r1 - r0)
        G = 1
        while G < 32 and 2 * G * lane_entries <= mean:
            G *= 2
        for r in range(r0, r1):
            y[r] = lanes_sum(prod[indptr[r] - e0:indptr[r + 1] - e0], G)
    return y


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_matvec_by_runs_matches_scipy_and_reference_kernel(name):
    """A float32 product that follows the partition, run by run and in the
    kernel's order of sums, against scipy's float64 product and the
    reference's PET kernel (interpret mode), each at 1e-5 of the output's
    scale: float32 sums of at most 5000 products in differing orders."""
    sp = RUN_CASES[name].astype(np.float32)
    sp.sort_indices()
    x = np.random.default_rng(6).standard_normal(sp.shape[1]).astype(np.float32)
    got = _matvec_by_runs(sp, x, 1024)
    assert not np.isnan(got).any()  # every row written once
    want = sp.astype(np.float64) @ x.astype(np.float64)
    scale = max(np.abs(want).max(initial=0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if sp.nnz:
        ref = j_spmv.PETOperator.from_scipy(sp, interpret=True, with_rmatvec=False)
        np.testing.assert_allclose(got, np.asarray(ref @ jnp.asarray(x)), rtol=0,
                                   atol=1e-5 * scale)
    # the wrapper's CPU path (the plain version) agrees too, with the runs passed
    indptr, indices, data = _csr_arrays(sp, torch.float32)
    plain = cuda_spmv.csr_matvec(indptr, indices, data, _t(x),
                                 _t(cuda_spmv.csr_runs(sp.indptr)))
    np.testing.assert_allclose(plain.numpy(), got, rtol=0, atol=1e-5 * scale)


def test_pet_operator_prepares_the_runs_once():
    """``_CSR`` cuts the runs when the operator is built, for the forward
    and the adjoint CSR, at the wrapper's capacity."""
    sp = RUN_CASES["bench irregular"].astype(np.float32)
    op = cuda_spmv.PETOperator.from_scipy(sp, with_rmatvec=True)
    for csr, mat in ((op._csr, sp), (op._csr_t, sp.T.tocsr())):
        assert csr.runs.dtype == torch.int32
        assert np.array_equal(csr.runs.numpy(), cuda_spmv.csr_runs(mat.indptr))
        assert len(csr.runs) - 1 >= mat.nnz // cuda_spmv.RUN_CAPACITY


# ---------------------------------------------------------------------------
# PETOperator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_rmatvec", [True, "lazy", False])
def test_pet_operator_matches_reference(with_rmatvec):
    sp = CASES["irregular"].astype(np.float32)
    op = cuda_spmv.PETOperator.from_scipy(sp, with_rmatvec=with_rmatvec)
    ref = j_spmv.PETOperator.from_scipy(sp, with_rmatvec=with_rmatvec, interpret=True)
    x = np.random.default_rng(3).standard_normal(sp.shape[0]).astype(np.float32)
    y = op @ _t(x.astype(np.float64))  # x is cast to float32, as the reference's
    assert y.dtype == torch.float32 and op.dtype == torch.float32
    assert op.nnz == sp.nnz and op.fill == 1.0 and op.shape == sp.shape
    want = np.asarray(ref @ jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(ref.diagonal()))
    if with_rmatvec is False:
        with pytest.raises(ValueError, match="no adjoint") as got_err:
            op.rmatvec(_t(x))
        with pytest.raises(ValueError) as want_err:
            ref.rmatvec(jnp.asarray(x))
        assert str(got_err.value) == str(want_err.value)
        return
    if with_rmatvec == "lazy":
        assert op._csr_t is None
    np.testing.assert_allclose(op.rmatvec(_t(x)).numpy(), sp.T @ x, rtol=0,
                               atol=1e-5 * np.abs(sp.T @ x).max())


def test_pet_bf16_values():
    sp = scipy.sparse.random(500, 800, density=0.02, random_state=1,
                             format="csr").astype(np.float32)
    op = cuda_spmv.PETOperator.from_scipy(sp, data_dtype=torch.bfloat16)
    ref = j_spmv.PETOperator.from_scipy(sp, interpret=True, data_dtype=jnp.bfloat16,
                                        with_rmatvec=False)
    assert op.dtype == torch.bfloat16
    assert cuda_spmv.PETOperator.from_scipy(sp, data_dtype=jnp.bfloat16).dtype == torch.bfloat16
    # the values rounded to bf16, as the operator stores them
    sp16 = sp.copy()
    sp16.data = torch.from_numpy(sp.data).to(torch.bfloat16).double().numpy()
    rng = np.random.default_rng(4)
    for x in (rng.standard_normal(800), rng.standard_normal((800, 4))):
        x = x.astype(np.float32)
        got = (op @ _t(x)).numpy()
        want = sp16 @ x.astype(np.float64)  # f32 x, f32 sums: 1e-5 of the scale
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        # the reference's bf16 mode also rounds x in its selection pass:
        # both within bf16 rounding of the f32 product
        for y in (got, np.asarray(ref @ jnp.asarray(x))):
            assert np.max(np.abs(y - sp @ x)) / (1 + np.max(np.abs(sp @ x))) < 2e-2
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_spmv.PETOperator.from_scipy(sp, data_dtype=torch.float16)


def _scrambled_poisson(g=40, seed=5):
    lap = scipy.sparse.kronsum(scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (g, g)),
                               scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (g, g)))
    perm = np.random.default_rng(seed).permutation(g * g)
    return lap.tocsr()[perm][:, perm].tocsr().astype(np.float32)


@pytest.mark.parametrize("reorder", ["rcm", "auto", "explicit", None])
def test_pet_reorder_matches_reference(reorder):
    """The reference's permutation (its "auto" rule included) and
    user-order results."""
    sp = _scrambled_poisson(100)  # 10^4 rows: a sampled fill below 0.15
    spec = np.random.default_rng(6).permutation(sp.shape[0]) if reorder == "explicit" \
        else reorder
    op = cuda_spmv.PETOperator.from_scipy(sp, reorder=spec)
    want_perm = j_spmv.resolve_reorder(sp, spec, metric="fill")
    if want_perm is None:
        assert op._perm is None and reorder is None
    else:
        np.testing.assert_array_equal(op._perm.numpy(), want_perm)
    if reorder == "auto":
        assert cuda_spmv.estimate_pet_fill(sp) == j_spmv.estimate_pet_fill(sp) < 0.15
    x = np.random.default_rng(7).standard_normal(sp.shape[0]).astype(np.float32)
    for got, want in ((op @ _t(x), sp @ x), (op.rmatvec(_t(x)), sp.T @ x)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_reorder_rules_match_reference():
    ordered = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(600, 600),
                                 format="csr")
    scr = _scrambled_poisson(30, seed=8)
    for sp in (ordered, scr):
        got = cuda_spmv.resolve_reorder(sp, "auto")
        want = j_spmv.resolve_reorder(sp, "auto", metric="fill")
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    p = cuda_spmv.rcm_permutation(scr)
    np.testing.assert_array_equal(cuda_spmv.invert_permutation(p)[p], np.arange(len(p)))
    rect = CASES["rect"].astype(np.float32)
    for spec in ("rcm", "auto"):
        with pytest.raises(ValueError, match="square matrix"):
            cuda_spmv.PETOperator.from_scipy(rect, reorder=spec)
    with pytest.raises(ValueError, match="unknown reorder"):
        cuda_spmv.resolve_reorder(scr, "nd")


# ---------------------------------------------------------------------------
# portable operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_csr_operator_matches_reference(dtype):
    rng = np.random.default_rng(9)
    sp = _irregular(400, 50, 12, seed=9)
    sp = (sp + 1j * _irregular(400, 50, 12, seed=10)).astype(dtype) if dtype == np.complex128 \
        else sp.astype(dtype)
    sp = (sp + scipy.sparse.identity(400)).tocsr()
    op = t_sparse.CSROperator.from_scipy(sp)
    ref = j_sparse.CSROperator.from_scipy(sp)
    assert op.nnz == ref.nnz and op.shape == ref.shape
    X = rng.standard_normal((400, 2)) + (1j * rng.standard_normal((400, 2))
                                          if dtype == np.complex128 else 0)
    for x in (X[:, 0], X):
        for got, want in ((op @ _t(x), ref @ jnp.asarray(x)),
                          (op.rmatvec(_t(x)), ref.rmatvec(jnp.asarray(x)))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.diagonal().numpy(), np.asarray(ref.diagonal()), rtol=1e-15)
    np.testing.assert_array_equal(op.todense().numpy(), np.asarray(ref.todense()))
    for name, kw in (("tril", {}), ("tril", dict(keep_diagonal=False)), ("triu", {}),
                     ("triu", dict(keep_diagonal=False))):
        np.testing.assert_array_equal(getattr(op, name)(**kw).todense().numpy(),
                                      np.asarray(getattr(ref, name)(**kw).todense()))
    d = rng.standard_normal(400)
    np.testing.assert_array_equal(op.with_diagonal(_t(d)).todense().numpy(),
                                  np.asarray(ref.with_diagonal(jnp.asarray(d)).todense()))
    dense = rng.standard_normal((30, 20)) * (rng.random((30, 20)) < 0.2)
    np.testing.assert_array_equal(t_sparse.CSROperator.from_dense(dense).todense().numpy(),
                                  dense)


def test_csr_operator_bf16_and_mixed_types():
    sp = CASES["irregular"]
    op = t_sparse.CSROperator.from_scipy(sp.astype(np.float32))
    op.data = op.data.to(torch.bfloat16)
    x = np.random.default_rng(11).standard_normal(sp.shape[0]).astype(np.float32)
    y = op @ _t(x)
    assert y.dtype == torch.float32
    assert np.max(np.abs(y.numpy() - sp @ x)) / (1 + np.max(np.abs(sp @ x))) < 2e-2
    # complex vector, real matrix: promoted, as the reference
    z = x + 1j * x[::-1]
    op64 = t_sparse.CSROperator.from_scipy(sp)
    np.testing.assert_allclose((op64 @ _t(z)).numpy(), sp @ z, rtol=1e-12, atol=1e-12)


def test_dia_operator_matches_reference():
    rng = np.random.default_rng(12)
    n = 50
    A = scipy.sparse.diags([rng.standard_normal(n - 3), rng.standard_normal(n),
                            rng.standard_normal(n - 1)], [-3, 0, 1], format="dia")
    op, ref = t_sparse.DiaOperator.from_scipy(A), j_sparse.DiaOperator.from_scipy(A)
    assert op.nnz == ref.nnz and op.offsets == tuple(ref.offsets)
    X = rng.standard_normal((n, 2))
    for x in (X[:, 0], X):
        np.testing.assert_allclose((op @ _t(x)).numpy(), np.asarray(ref @ jnp.asarray(x)),
                                   rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(op.rmatvec(_t(x)).numpy(),
                                   np.asarray(ref.rmatvec(jnp.asarray(x))),
                                   rtol=1e-13, atol=1e-14)
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(ref.diagonal()))
    np.testing.assert_array_equal(op.tocsr().todense().numpy(),
                                  np.asarray(ref.tocsr().todense()))


# ---------------------------------------------------------------------------
# BSR (K12 plain version) and detect_blocksize
# ---------------------------------------------------------------------------


def _block_tridiag(n=2048, R=32, seed=3, spd=False):
    rng = np.random.default_rng(seed)
    nb = n // R
    dense = np.zeros((n, n))
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            dense[i * R:(i + 1) * R, j * R:(j + 1) * R] = rng.standard_normal((R, R))
    if spd:
        dense = dense @ dense.T + n * np.eye(n)
    return dense


@pytest.mark.parametrize("R,C,k", [(32, 32, 8), (8, 16, 3), (128, 128, 1)])
def test_k12_plain_matches_reference_kernel(R, C, k):
    rng = np.random.default_rng(R + k)
    nbrows, max_blocks, nbcols = 4, 3, 5
    data = rng.standard_normal((nbrows * max_blocks, R, C)).astype(np.float32)
    cols = rng.integers(0, nbcols, (nbrows, max_blocks)).astype(np.int32)
    x = rng.standard_normal((nbcols * C, k)).astype(np.float32)
    got = cuda_bsr.bsr_spmm(_t(data), _t(cols), _t(x))
    want = np.asarray(j_pallas_bsr.bsr_spmm(jnp.asarray(data), jnp.asarray(cols),
                                            jnp.asarray(x), interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bsr_operator_matches_reference(dtype):
    dense = _block_tridiag(512, 32, seed=13).astype(dtype)
    if dtype == np.complex128:
        dense = dense + 1j * _block_tridiag(512, 32, seed=14)
    sp = scipy.sparse.csr_matrix(dense)
    op = t_bsr.BSROperator.from_scipy(sp, blocksize=(32, 32))
    ref = j_bsr.BSROperator.from_scipy(sp, blocksize=(32, 32))
    np.testing.assert_array_equal(op.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(ref.cols))
    assert op.nnz == ref.nnz and op.blocksize == tuple(ref.blocksize)
    rng = np.random.default_rng(15)
    X = rng.standard_normal((512, 3))
    for x in (X[:, 0], X):
        np.testing.assert_allclose((op @ _t(x)).numpy(), dense @ x, rtol=1e-12, atol=1e-11)
        np.testing.assert_allclose(op.rmatvec(_t(x)).numpy(), dense.conj().T @ x,
                                   rtol=1e-12, atol=1e-11)
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(ref.diagonal()))
    np.testing.assert_array_equal(op.todense().numpy(), dense)


def _arrow(n=4096, R=32, seed=7):
    rng = np.random.default_rng(seed)
    nb = n // R
    blocks = [(0, j) for j in range(nb)] + [(i, i) for i in range(1, nb)]
    rows, cols = [], []
    for bi, bj in blocks:
        rr, cc = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
        rows.append((bi * R + rr).ravel())
        cols.append((bj * R + cc).ravel())
    return scipy.sparse.csr_matrix(
        (rng.standard_normal(len(blocks) * R * R),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))


@pytest.mark.parametrize("case", ["block", "scattered", "arrow", "small", "rect64"])
def test_detect_blocksize_matches_reference(case):
    sp = {
        "block": lambda: scipy.sparse.csr_matrix(_block_tridiag()),
        "scattered": lambda: scipy.sparse.random(2048, 2048, density=0.02, random_state=0,
                                                 format="csr"),
        "arrow": _arrow,
        "small": lambda: scipy.sparse.csr_matrix(_block_tridiag(256, 32)),
        "rect64": lambda: scipy.sparse.csr_matrix(_block_tridiag(2048, 64)[:, :1024]),
    }[case]()
    assert t_bsr.detect_blocksize(sp) == j_bsr.detect_blocksize(sp)
    if case == "block":
        assert t_bsr.detect_blocksize(sp) == (32, 32)
    if case == "arrow":
        assert t_bsr.detect_blocksize(sp) is None


# ---------------------------------------------------------------------------
# routing and the route cache
# ---------------------------------------------------------------------------


def _kind(op):
    return type(op).__name__


def test_routing_matches_reference_on_cpu():
    """Without a CUDA device the port routes as the reference does on its
    CPU (f64 parity): block-structured to BSR, everything else to CSR."""
    cases = [scipy.sparse.csr_matrix(_block_tridiag()),
             scipy.sparse.random(2048, 2048, density=0.02, random_state=0, format="csr"),
             CASES["tridiag"], CASES["rect"]]
    rng = np.random.default_rng(16)
    for sp in cases:
        op, ref = t_ops.as_operator(sp), j_ops.as_operator(sp)
        assert _kind(op) == _kind(ref)
        x = rng.standard_normal(sp.shape[1])
        np.testing.assert_allclose((op @ _t(x)).numpy(), np.asarray(ref @ jnp.asarray(x)),
                                   rtol=1e-12, atol=1e-11)
    assert kt.aslinearoperator is kt.as_operator


def test_routing_on_a_cuda_device(monkeypatch):
    """On a CUDA device (the device check monkeypatched, so the operators
    are built on the CPU) large real float32 matrices go to PETOperator,
    with a lazy adjoint and reorder="auto"; float64, complex and small
    ones keep CSROperator, as the reference's TPU routing (mocked the same
    way) keeps its portable path for them."""
    import types

    import jax

    monkeypatch.setattr(t_ops, "_pet_device", lambda device: True)
    fake_jax = types.SimpleNamespace(Array=jax.Array, default_backend=lambda: "tpu",
                                     config=types.SimpleNamespace(jax_enable_x64=False))
    monkeypatch.setattr(j_ops, "jax", fake_jax)
    big = scipy.sparse.random(2048, 2048, density=0.02, random_state=0, format="csr")
    f32 = big.astype(np.float32)
    op = t_ops.as_operator(f32)
    assert _kind(op) == "PETOperator" == _kind(j_ops._route_scipy_sparse(f32))
    assert op._csr_t is None and op._sp is not None  # lazy adjoint
    for sp in (big, (big + 1j * big).tocsr(), CASES["tridiag"].astype(np.float32)):
        assert _kind(t_ops.as_operator(sp)) == "CSROperator"
    assert _kind(t_ops.as_operator(scipy.sparse.csr_matrix(_block_tridiag()))) == "BSROperator"


def test_route_cache_mutation_eviction_and_device():
    sp = scipy.sparse.random(256, 256, density=0.05, random_state=5,
                             format="csr").astype(np.float32)
    calls = []

    def build(A):
        calls.append(1)
        return ("op", len(calls))

    op1 = t_ops._route_cached(sp, None, build)
    assert t_ops._route_cached(sp, "cpu", build) is op1 and len(calls) == 1
    # one matrix routed for another device gives a second operator
    op_meta = t_ops._route_cached(sp, torch.device("meta"), build)
    assert op_meta is not op1 and len(calls) == 2
    sp.data[1] *= 100.0  # a single in-place edit rebuilds
    assert t_ops._route_cached(sp, None, build) is not op1 and len(calls) == 3
    keys = [k for k in t_ops._ROUTE_CACHE if k[0] == id(sp)]
    assert len(keys) == 2
    del sp
    gc.collect()
    assert not any(k in t_ops._ROUTE_CACHE for k in keys), "dead entries must evict"


def test_route_cache_evicts_lazy_pet_chain():
    sp = scipy.sparse.random(300, 300, density=0.05, random_state=9,
                             format="csr").astype(np.float32)
    op = t_ops._route_cached(
        sp, None, lambda A: cuda_spmv.PETOperator.from_scipy(A, with_rmatvec="lazy"))
    key = (id(sp), "cpu")
    assert key in t_ops._ROUTE_CACHE
    del sp
    gc.collect()
    assert key not in t_ops._ROUTE_CACHE, "the lazy operator kept the matrix alive"
    with pytest.raises(ValueError, match="garbage collection"):
        op.rmatvec(torch.ones(300))


def test_two_sided_setup_builds_the_lazy_adjoint():
    from krylov_tpu_torch.solvers._common import setup

    sp = scipy.sparse.random(300, 300, density=0.05, random_state=9,
                             format="csr").astype(np.float32)
    op = cuda_spmv.PETOperator.from_scipy(sp, with_rmatvec="lazy")
    setup(op, torch.ones(300))
    assert op._csr_t is None
    setup(op, torch.ones(300), needs_rmatvec=True)
    assert op._csr_t is not None


# ---------------------------------------------------------------------------
# tocsr, convert, triangular
# ---------------------------------------------------------------------------


def test_stencil_tocsr_matches_reference():
    a = np.exp(np.random.default_rng(17).standard_normal((9, 11)))
    pairs = [
        (t_stencil.poisson_1d(17), j_stencil.poisson_1d(17)),  # BandedOperator
        (t_stencil.poisson_2d(7, 9), j_stencil.poisson_2d(7, 9)),
        (t_stencil.diffusion_2d(a), j_stencil.diffusion_2d(a)),
        (t_stencil.poisson_2d_const(7, 9, dtype=np.float64),
         j_stencil.poisson_2d_const(7, 9, dtype=np.float64)),
        (t_stencil.poisson_3d_const(3, 4, 5, dtype=np.float64),
         j_stencil.poisson_3d_const(3, 4, 5, dtype=np.float64)),
    ]
    for op, ref in pairs:
        got = op.tocsr()
        assert _kind(got) == "CSROperator"
        np.testing.assert_array_equal(got.todense().numpy(), np.asarray(ref.tocsr().todense()))


def test_convert_sparse_formats_from_reference():
    rng = np.random.default_rng(18)
    sp = CASES["irregular"]
    x = rng.standard_normal(sp.shape[0])
    csr = convert.from_reference(j_sparse.CSROperator.from_scipy(sp))
    np.testing.assert_allclose((csr @ _t(x)).numpy(), sp @ x, rtol=1e-12, atol=1e-12)
    dia = convert.from_reference(j_sparse.DiaOperator.from_scipy(CASES["tridiag"].todia()))
    y = rng.standard_normal(300)
    np.testing.assert_allclose((dia @ _t(y)).numpy(), CASES["tridiag"] @ y, rtol=1e-13)
    dense = _block_tridiag(512, 32, seed=19)
    bsr = convert.from_reference(j_bsr.BSROperator.from_scipy(scipy.sparse.csr_matrix(dense),
                                                              blocksize=(32, 32)))
    z = rng.standard_normal(512)
    np.testing.assert_allclose((bsr @ _t(z)).numpy(), dense @ z, rtol=1e-12, atol=1e-11)
    f32 = _scrambled_poisson(30, seed=20)
    for kw in (dict(with_rmatvec=True, reorder="rcm"), dict(with_rmatvec="lazy")):
        ref = j_spmv.PETOperator.from_scipy(f32, interpret=True, **kw)
        pet = convert.from_reference(ref, source=f32)
        assert _kind(pet) == "PETOperator"
        assert (pet._perm is None) == (ref._perm is None)
        v = rng.standard_normal(f32.shape[0]).astype(np.float32)
        np.testing.assert_allclose(pet.rmatvec(_t(v)).numpy(), f32.T @ v, rtol=0,
                                   atol=1e-5 * np.abs(f32.T @ v).max())


@pytest.mark.parametrize("lower", [False, True])
def test_multi_solve_triangular_matches_reference(lower):
    rng = np.random.default_rng(21)
    k = 6
    A = rng.standard_normal((k, k, 3)) + 4 * np.eye(k)[:, :, None]
    A = np.tril(A.transpose(2, 0, 1)).transpose(1, 2, 0) if lower else \
        np.triu(A.transpose(2, 0, 1)).transpose(1, 2, 0)
    B = rng.standard_normal((k, 3))
    B[:, 1] = 0.0  # a converged column: its singular R must not matter
    A[:, :, 1] = 0.0
    got = multi_solve_triangular(_t(A), _t(B), lower=lower)
    want = np.asarray(j_tri.multi_solve_triangular(jnp.asarray(A), jnp.asarray(B),
                                                   lower=lower))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    assert np.all(got.numpy()[:, 1] == 0.0)


def test_sparse_solves_match_reference():
    """bicgstab and gmres on a scipy CSR matrix, through as_operator."""
    g = 16
    n = g * g
    sp = scipy.sparse.diags([-1.0, -1.0, 4.5, -1.0, -1.0], [-g, -1, 0, 1, g],
                            shape=(n, n), format="csr")
    conv = scipy.sparse.diags([-0.4, 0.4], [-1, 1], shape=(n, n), format="csr")
    b = np.random.default_rng(22).standard_normal(n)
    dinv = 1.0 / sp.diagonal()
    _, it = kt.bicgstab(sp, b, Ml=kt.DiagonalOperator(_t(dinv)), tol=1e-8,
                        backend="while_loop")
    _, ij = krylov_tpu.bicgstab(sp, b, Ml=krylov_tpu.DiagonalOperator(jnp.asarray(dinv)),
                                tol=1e-8)
    assert it.success and it.numsteps == ij.numsteps
    np.testing.assert_allclose(it.resnorms, np.asarray(ij.resnorms), rtol=1e-9,
                               atol=1e-13 * it.resnorms[0])
    A = (sp + conv).tocsr()
    _, it = kt.gmres(A, b, tol=1e-8, maxiter=80, backend="while_loop")
    _, ij = krylov_tpu.gmres(A, b, tol=1e-8, maxiter=80, backend="while_loop")
    assert it.success and it.numsteps == ij.numsteps
    np.testing.assert_allclose(it.resnorms, np.asarray(ij.resnorms), rtol=1e-9,
                               atol=1e-13 * it.resnorms[0])


def test_operators_refuse_mismatched_vectors():
    """The kernels gather x by stored column: a short x must raise before
    any pointer reaches them."""
    pet = cuda_spmv.PETOperator.from_scipy(CASES["rect"].astype(np.float32))
    bsr = t_bsr.BSROperator.from_scipy(scipy.sparse.csr_matrix(_block_tridiag(256, 32)),
                                       blocksize=(32, 32))
    for op in (pet, bsr):
        for x in (torch.ones(op.shape[1] - 1), torch.ones((op.shape[1], 2, 2))):
            with pytest.raises(ValueError, match="does not match"):
                op @ x


# ---------------------------------------------------------------------------
# the route cache's content checksum, K10's cached runs, K12's chooser
# ---------------------------------------------------------------------------


def _routed(sp, calls):
    def build(A):
        calls.append(1)
        return ("op", len(calls))

    return t_ops._route_cached(sp, None, build)


def _swap(arr, i, j):
    arr[i], arr[j] = arr[j].copy(), arr[i].copy()


@pytest.mark.parametrize("n", [300, 4000])
@pytest.mark.parametrize("edit", ["none", "one entry", "swap data", "swap indices",
                                  "swap far data", "indptr", "last entry"])
def test_route_cache_sees_every_in_place_edit(edit, n):
    """Any in-place edit of a buffer misses the cache: a changed value, two
    swapped values (next to each other and 100k bytes apart), two swapped
    column indices within a row, a moved row pointer; an unedited matrix
    hits it.  ``n = 4000`` gives buffers of several checksum rows (8 KB
    each), ``n = 300`` buffers shorter than one."""
    sp = scipy.sparse.random(n, n, density=20 / n, random_state=5, format="csr")
    sp.sort_indices()
    calls = []
    op = _routed(sp, calls)
    row = int(np.flatnonzero(np.diff(sp.indptr) >= 2)[0])
    lo = sp.indptr[row]
    if edit == "one entry":
        sp.data[lo] += 1.0
    elif edit == "swap data":
        assert sp.data[lo] != sp.data[lo + 1]
        _swap(sp.data, lo, lo + 1)
    elif edit == "swap far data":
        assert sp.data[3] != sp.data[-5]
        _swap(sp.data, 3, sp.nnz - 5)
    elif edit == "swap indices":
        assert sp.indices[lo] != sp.indices[lo + 1]
        _swap(sp.indices, lo, lo + 1)
    elif edit == "indptr":
        sp.indptr[row + 1] -= 1
    elif edit == "last entry":
        sp.data[-1] *= 2.0
    again = _routed(sp, calls)
    assert (again is op) == (edit == "none")
    assert len(calls) == (1 if edit == "none" else 2)
    assert _routed(sp, calls) is again  # and the edited matrix hits from then on
    key = (id(sp), "cpu")
    del sp
    gc.collect()
    assert key not in t_ops._ROUTE_CACHE, "the weak reference must evict"


def test_buffer_checksum_reads_whole_buffers_of_any_type():
    rng = np.random.default_rng(3)
    for arr in (rng.standard_normal(5000).astype(np.float32), rng.integers(0, 99, 3001),
                rng.standard_normal(1500) + 1j, np.arange(7, dtype=np.int16),
                rng.standard_normal((70, 70))[::2]):  # non-contiguous
        base = t_ops._buffer_checksum(arr)
        assert base == t_ops._buffer_checksum(arr.copy())
        for pos in (0, arr.size // 2, arr.size - 1):
            edited = arr.copy()
            edited.reshape(-1)[pos] += 1
            assert t_ops._buffer_checksum(edited) != base, (arr.dtype, pos)
    # the same numbers in another order, within a checksum row and across rows
    arr = rng.standard_normal(4096)
    for i, j in ((10, 11), (10, 900), (10, 3000)):
        edited = arr.copy()
        _swap(edited, i, j)
        assert t_ops._buffer_checksum(edited) != t_ops._buffer_checksum(arr)
    coo = scipy.sparse.random(50, 50, density=0.1, random_state=1, format="coo")
    fp = t_ops._sparse_fingerprint(coo)
    _swap(coo.row, 0, 1)
    assert coo.row[0] != coo.row[1] and t_ops._sparse_fingerprint(coo) != fp


def test_cached_runs_are_made_once_per_indptr_tensor():
    indptr = _t(np.array([0, 2, 3, 7, 7, 9], np.int32))
    runs = cuda_spmv.cached_runs(indptr)
    assert runs.dtype == torch.int32
    assert np.array_equal(runs.numpy(), cuda_spmv.csr_runs(indptr.numpy()))
    assert cuda_spmv.cached_runs(indptr) is runs  # the second call copies nothing
    assert cuda_spmv.cached_runs(indptr[:]) is runs  # a view of the same storage
    other = indptr.clone()
    assert cuda_spmv.cached_runs(other) is not runs
    indptr[1] = 1  # an in-place edit bumps the tensor's version: a miss
    assert cuda_spmv.cached_runs(indptr) is not runs
    n = len(cuda_spmv._RUNS_CACHE)
    del indptr, other
    gc.collect()
    assert len(cuda_spmv._RUNS_CACHE) <= n - 2, "a freed tensor evicts its entries"


@pytest.mark.parametrize("dtype,C,k,off,want", [
    (torch.float32, 32, 8, 0, True),
    (torch.float32, 128, 32, 0, True),
    (torch.float32, 48, 17, 0, True),      # rows of 12 pieces, any k up to 32
    (torch.float32, 30, 8, 0, False),      # C % 4 != 0
    (torch.float32, 32, 33, 0, False),     # k * 4 bytes > 128
    (torch.float32, 32, 8, 4, False),      # a buffer off the 16-byte boundary
    (torch.float64, 32, 16, 0, True),
    (torch.float64, 31, 4, 0, False),
    (torch.float64, 32, 17, 0, False),
    (torch.complex64, 6, 16, 0, True),
    (torch.complex64, 5, 1, 0, False),
    (torch.complex128, 3, 8, 0, True),     # every row is whole 16-byte pieces
    (torch.complex128, 3, 9, 0, False),
    (torch.complex128, 3, 8, 8, False),
])
def test_k12_chooser_reads_type_shape_and_alignment_alone(dtype, C, k, off, want):
    addresses = [1 << 20, (1 << 21) + off, 1 << 22]
    assert cuda_bsr.k12_streamed(dtype, C, k, addresses) is want


def test_k12_cpu_tensors_take_the_plain_version_and_count_nothing():
    cuda_bsr.reset_launches()
    data, cols, x = torch.ones(2, 4, 4), torch.zeros((2, 1), dtype=torch.int32), torch.ones(4, 3)
    assert torch.equal(cuda_bsr.bsr_spmm(data, cols, x), torch.full((8, 3), 4.0))
    assert cuda_bsr.LAUNCHES == {"bsr_spmm": 0}
    assert cuda_bsr.K12_PATHS == {"streamed": 0, "general": 0}
