"""The adjoint products of krylov_tpu_torch in one fixed order, held to
krylov_tpu on the CPU.

``CSROperator.rmatvec`` is the matvec of a column-grouped copy of the
matrix (a gather and a segment sum over each column's entries), and
``BSROperator.rmatvec`` is K12 on the block transpose (or, past its
padding limit, a column-sorted segment sum): no scatter-add, so on every
device an adjoint product sums in one order and a solve repeats bit for
bit.  The CPU takes the same route as the card, so these tests hold it to
the reference's ``rmatvec`` (``jax.ops.segment_sum``):

* the products, for float32, float64 and complex128, square and
  rectangular, with an empty column and a dense row (CSR), square and
  rectangular blocks and a dense block column (BSR);
* ``bicg``, ``qmr``, ``cgnr`` and ``lsqr`` on a float64 CSR and a float64
  BSR matrix against the reference's eager solves (each computed once),
  host-stepped and on the CPU twin of the graph route, which must agree
  bit for bit;
* no ``index_add_`` or ``index_put_`` on any adjoint path, a forward-only
  solve building no copy, and the sharded products on two gloo ranks.

Tolerances: rtol 1e-12 in float64 and complex128, 1e-5 in float32, on each
entry beside the same fraction of the largest entry (an entry summed to
near zero by cancellation has no relative accuracy in either package).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import bsr as j_bsr
from krylov_tpu.ops import sparse as j_sparse
from krylov_tpu_torch import _driver
from krylov_tpu_torch.ops import bsr as t_bsr
from krylov_tpu_torch.ops import cuda_bsr
from krylov_tpu_torch.ops import sparse as t_sparse
from krylov_tpu_torch.parallel import _spawn

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

RTOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex128: 1e-12}
DTYPES = sorted(RTOL, key=lambda t: t.__name__)
SOLVERS = ("bicg", "qmr", "cgnr", "lsqr")
ROUTES = ("eager", "host", "plain_graph")


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _values(rng, n, dtype):
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _csr(shape, dtype, seed=0):
    """A random CSR matrix of ``shape`` with an empty column (3) and a
    dense row (1)."""
    rng = np.random.default_rng(seed)
    m, n = shape
    sp = scipy.sparse.random(m, n, density=0.15, random_state=seed, format="lil")
    sp[1, :] = 1.0 + rng.random(n)
    sp[:, 3] = 0.0
    sp = sp.tocsr()
    sp.eliminate_zeros()
    sp.data = _values(rng, sp.nnz, dtype)
    return sp


@pytest.mark.parametrize("shape", [(40, 40), (52, 31)], ids=["square", "rect"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: t.__name__)
def test_csr_rmatvec_matches_reference(dtype, shape):
    sp = _csr(shape, dtype)
    assert np.all(sp[:, 3].toarray() == 0) and sp[1].nnz == shape[1] - 1
    port = t_sparse.CSROperator.from_scipy(sp, device="cpu")
    ref = j_sparse.CSROperator.from_scipy(sp)
    rng = np.random.default_rng(1)
    for x in (_values(rng, shape[0], dtype), _values(rng, 3 * shape[0], dtype).reshape(-1, 3)):
        got = port.rmatvec(torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == (shape[1],) + x.shape[1:]
        _close(got.numpy(), ref.rmatvec(jnp.asarray(x)), RTOL[dtype])
        assert torch.all(got[3] == 0)  # the empty column: an exact 0
    copy = port._adjoint
    assert copy.shape == (shape[1], shape[0]) and copy.indptr.numel() == shape[1] + 1


def _block_matrix(case, dtype, seed=2):
    """``(scipy matrix, blocksize)``: random blocks on a random block
    pattern (``square``: 4 x 4 blocks, ``rect``: 3 x 5), or a dense block
    column beside a block diagonal (``dense_column``)."""
    rng = np.random.default_rng(seed)
    if case == "dense_column":
        R = C = 4
        nb = 24
        pattern = np.eye(nb, dtype=bool)
        pattern[:, 5] = True
    else:
        R, C = (4, 4) if case == "square" else (3, 5)
        nb = 10
        pattern = rng.random((nb, 8 if case == "rect" else nb)) < 0.3
        pattern[np.arange(min(pattern.shape)), np.arange(min(pattern.shape))] = True
    rows, cols = np.nonzero(pattern)
    blocks = _values(rng, rows.size * R * C, dtype).reshape(-1, R, C)
    shape = (pattern.shape[0] * R, pattern.shape[1] * C)
    indptr = np.searchsorted(rows, np.arange(pattern.shape[0] + 1))
    return scipy.sparse.bsr_matrix((blocks, cols, indptr), shape=shape).tocsr(), (R, C)


@pytest.mark.parametrize("case", ["square", "rect", "dense_column"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: t.__name__)
def test_bsr_rmatvec_matches_reference(dtype, case):
    sp, bs = _block_matrix(case, dtype)
    port = t_bsr.BSROperator.from_scipy(sp, blocksize=bs, device="cpu")
    ref = j_bsr.BSROperator.from_scipy(sp, blocksize=bs)
    rng = np.random.default_rng(3)
    cuda_bsr.reset_launches()
    for x in (_values(rng, sp.shape[0], dtype), _values(rng, 3 * sp.shape[0], dtype).reshape(-1, 3)):
        got = port.rmatvec(torch.from_numpy(x))
        assert got.shape == (sp.shape[1],) + x.shape[1:]
        _close(got.numpy(), ref.rmatvec(jnp.asarray(x)), RTOL[dtype])
    route = "segment" if case == "dense_column" else "k12"
    assert port._adjoint.route == route
    assert cuda_bsr.ADJOINT_PATHS == {"k12": 0, "segment": 0, route: 2}


def test_bsr_transpose_layout():
    """The K12 route's transpose: blocks ``(r, c)`` at ``(c, r)``
    conjugate-transposed, each block row in ascending old block row, pads
    at block column 0 with zero blocks; block columns that hold no block
    come back as exact zeros."""
    sp, (R, C) = _block_matrix("rect", np.complex128)
    op = t_bsr.BSROperator.from_scipy(sp, blocksize=(R, C), device="cpu")
    adj = op.ensure_adjoint()._adjoint
    dense = sp.toarray()
    nbrows = sp.shape[0] // R
    for j, rows in enumerate(adj.cols.numpy()):
        c = j if adj.held is None else int(adj.held[j])
        stored = [r for r in range(nbrows) if np.any(dense[r * R:(r + 1) * R, c * C:(c + 1) * C])]
        assert list(rows[:len(stored)]) == stored and not np.any(rows[len(stored):])
        blocks = adj.data.numpy()[j * adj.cols.shape[1]:(j + 1) * adj.cols.shape[1]]
        for s, r in enumerate(stored):
            np.testing.assert_array_equal(blocks[s], dense[r * R:(r + 1) * R,
                                                           c * C:(c + 1) * C].conj().T)
        assert not np.any(blocks[len(stored):])
    x = torch.from_numpy(_values(np.random.default_rng(4), sp.shape[0], np.complex128))
    empty = [c for c in range(sp.shape[1] // C) if not np.any(dense[:, c * C:(c + 1) * C])]
    got = op.rmatvec(x).reshape(-1, C)
    assert all(torch.all(got[c] == 0) for c in empty)


def _solver_matrix(fmt):
    """A nonsymmetric, well-conditioned float64 matrix (128 rows): a CSR
    one, or one of 4 x 4 blocks on a block-tridiagonal pattern."""
    rng = np.random.default_rng(5)
    if fmt == "csr":
        n = 128
        sp = scipy.sparse.random(n, n, density=0.04, random_state=6, format="csr")
        sp = (sp + scipy.sparse.diags(4.0 + rng.random(n))).tocsr()
        return sp, t_sparse.CSROperator.from_scipy(sp, device="cpu"), \
            j_sparse.CSROperator.from_scipy(sp)
    nb, R = 32, 4
    rows = np.concatenate([np.arange(nb), np.arange(nb - 1), np.arange(1, nb)])
    cols = np.concatenate([np.arange(nb), np.arange(1, nb), np.arange(nb - 1)])
    blocks = 0.2 * rng.standard_normal((rows.size, R, R))
    blocks[:nb] += 4.0 * np.eye(R)
    order = np.lexsort((cols, rows))
    indptr = np.searchsorted(rows[order], np.arange(nb + 1))
    sp = scipy.sparse.bsr_matrix((blocks[order], cols[order], indptr),
                                 shape=(nb * R, nb * R)).tocsr()
    return sp, t_bsr.BSROperator.from_scipy(sp, blocksize=(R, R), device="cpu"), \
        j_bsr.BSROperator.from_scipy(sp, blocksize=(R, R))


def _rhs(n):
    return np.random.default_rng(7).standard_normal(n)


@functools.cache
def _reference(solver, fmt):
    """The reference's eager solve, once for every route of the port."""
    sp, _, ref = _solver_matrix(fmt)
    _, info = getattr(krylov_tpu, solver)(ref, jnp.asarray(_rhs(sp.shape[0])), tol=1e-10,
                                          maxiter=200)
    return int(info.numsteps), np.asarray(info.resnorms), np.asarray(info.xk)


def _port_solve(solver, op, b, route):
    if route == "eager":
        return getattr(kt, solver)(op, b, tol=1e-10, maxiter=200)[1]
    ctx = _driver._host_stepped() if route == "host" else _driver._plain_graph(3, 4, 2)
    with ctx:
        return getattr(kt, solver)(op, b, tol=1e-10, maxiter=200, backend="while_loop")[1]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fmt", ["csr", "bsr"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_two_sided_solvers_match_reference(solver, fmt, route):
    """Equal ``numsteps``, resnorms within rtol 1e-12, iterates within
    1e-12; the plain graph twin bit-equal to the host-stepped loop."""
    sp, op, _ = _solver_matrix(fmt)
    b = torch.from_numpy(_rhs(sp.shape[0]))
    numsteps, resnorms, xk = _reference(solver, fmt)
    info = _port_solve(solver, op, b, route)
    assert info.success and info.numsteps == numsteps > 3
    _close(info.resnorms, resnorms, RTOL[np.float64])
    _close(info.xk.numpy(), xk, RTOL[np.float64])
    if route == "plain_graph":
        host = _port_solve(solver, op, b, "host")
        np.testing.assert_array_equal(info.resnorms, host.resnorms)
        assert torch.equal(info.xk, host.xk)


@pytest.mark.parametrize("fmt", ["csr", "bsr"])
def test_lsqr_on_a_rectangular_matrix(fmt):
    """``lsqr`` on a 160 x 128 least-squares problem: the copy of a
    rectangular ``A`` has ``shape[1]`` segments (block rows)."""
    sp, _, _ = _solver_matrix(fmt)
    tall = scipy.sparse.vstack([sp, sp[:32] * 0.5]).tocsr()
    if fmt == "csr":
        op, ref = t_sparse.CSROperator.from_scipy(tall, device="cpu"), \
            j_sparse.CSROperator.from_scipy(tall)
    else:
        op = t_bsr.BSROperator.from_scipy(tall, blocksize=(4, 4), device="cpu")
        ref = j_bsr.BSROperator.from_scipy(tall, blocksize=(4, 4))
    b = _rhs(tall.shape[0])
    _, want = krylov_tpu.lsqr(ref, jnp.asarray(b), tol=1e-10, maxiter=200)
    _, got = kt.lsqr(op, torch.from_numpy(b), tol=1e-10, maxiter=200)
    assert got.numsteps == int(want.numsteps)
    _close(got.resnorms, np.asarray(want.resnorms), RTOL[np.float64])
    _close(got.xk.numpy(), np.asarray(want.xk), RTOL[np.float64])


def _raise(*args, **kwargs):
    raise AssertionError("a scatter-add on an adjoint path")


def test_no_scatter_add_on_any_adjoint_path(monkeypatch):
    """With ``index_add_`` and ``index_put_`` made to raise: every adjoint
    product (CSR in three types, both BSR routes, the products with a
    gradient to the data, K12's gradient to X, the sharded operators on a
    world of one) and the four two-sided solvers on CSR and BSR."""
    monkeypatch.setattr(torch.Tensor, "index_add_", _raise)
    monkeypatch.setattr(torch.Tensor, "index_put_", _raise)
    rng = np.random.default_rng(8)
    for dtype in DTYPES:
        sp = _csr((30, 20), dtype)
        op = t_sparse.CSROperator.from_scipy(sp, device="cpu")
        x = _values(rng, 30, dtype)
        _close(op.rmatvec(torch.from_numpy(x)).numpy(), sp.conj().T @ x, RTOL[dtype])
    for case in ("square", "rect", "dense_column"):
        sp, bs = _block_matrix(case, np.complex128)
        op = t_bsr.BSROperator.from_scipy(sp, blocksize=bs, device="cpu")
        x = _values(rng, sp.shape[0], np.complex128)
        _close(op.rmatvec(torch.from_numpy(x)).numpy(), sp.conj().T @ x, RTOL[np.complex128])
    # a gradient to the data through each adjoint, and K12's to X
    sp, bs = _block_matrix("square", np.float64)
    bop = t_bsr.BSROperator.from_scipy(sp, blocksize=bs, device="cpu")
    bop.data.requires_grad_()
    x = torch.from_numpy(_values(rng, sp.shape[0], np.float64))
    bop.rmatvec(x).sum().backward()
    assert bop.data.grad is not None and bop.data.grad.abs().sum() > 0
    X = torch.from_numpy(_values(rng, 3 * sp.shape[1], np.float64).reshape(-1, 3))
    X.requires_grad_()
    cuda_bsr.bsr_spmm(bop.data.detach(), bop.cols, X).sum().backward()
    want = sp.T @ np.ones((sp.shape[0], 3))
    _close(X.grad.numpy(), want, RTOL[np.float64])
    csr = t_sparse.CSROperator.from_scipy(_csr((30, 20), np.float64), device="cpu")
    csr.data.requires_grad_()
    csr.rmatvec(torch.ones(30, dtype=torch.float64)).sum().backward()
    assert csr.data.grad is not None
    for fmt in ("csr", "bsr"):
        sp, op, _ = _solver_matrix(fmt)
        b = torch.from_numpy(_rhs(sp.shape[0]))
        for solver in SOLVERS:
            assert _port_solve(solver, op, b, "host").success
            _, fresh, _ = _solver_matrix(fmt)  # its copy built under the patch
            assert _port_solve(solver, fresh, b, "plain_graph").success


@pytest.mark.parametrize("solver", ["cg", "gmres", "bicgstab"])
def test_a_forward_only_solve_builds_no_adjoint(solver):
    """``cg``, ``gmres`` and ``bicgstab`` (50 steps; ``cg`` does not
    converge on these nonsymmetric matrices) on a CSR and a BSR operator and
    on a scipy matrix routed by ``as_operator`` build no copy; a two-sided
    solve builds one, once, on the operator the route cache holds."""
    for fmt in ("csr", "bsr"):
        sp, op, _ = _solver_matrix(fmt)
        b = torch.from_numpy(_rhs(sp.shape[0]))
        for A in (op, sp):
            getattr(kt, solver)(A, b, tol=1e-8, maxiter=50)
            routed = A if A is op else kt.as_operator(sp, "cpu")
            assert routed._adjoint is None, (solver, fmt)
        kt.bicg(sp, b, tol=1e-8, maxiter=200)
        copy = kt.as_operator(sp, "cpu")._adjoint
        assert copy is not None
        kt.qmr(sp, b, tol=1e-8, maxiter=200)
        assert kt.as_operator(sp, "cpu")._adjoint is copy


@pytest.fixture(scope="module")
def pool():
    with _spawn.SPMDPool(2, timeout=120.0) as p:
        yield p


@pytest.mark.parametrize("case", ["csr_banded", "csr_random", "bsr_k12", "bsr_segment"])
def test_sharded_rmatvec_on_two_ranks(pool, case):
    """The sharded operators' adjoints (each rank's local copy, then the
    halo return for CSR, ``reduce_scatter_rows`` for BSR) against the
    single-device one, float64: a banded CSR, a random one with an empty
    column and a dense row (on two ranks every square CSR takes the halo
    mode; ``tests/test_torch_parallel.py`` runs the gather mode on four),
    BSR on both routes."""
    rng = np.random.default_rng(9)
    if case == "csr_banded":
        sp = scipy.sparse.diags([rng.random(63), 2 + rng.random(64), rng.random(62)],
                                [-1, 0, 2], format="csr")
        A = sp
    elif case == "csr_random":
        A = sp = _csr((64, 64), np.float64, seed=10)
    else:
        sp, bs = (_solver_matrix("bsr")[0], (4, 4)) if case == "bsr_k12" else \
            _block_matrix("dense_column", np.float64)
        A = t_bsr.BSROperator.from_scipy(sp, blocksize=bs, device="cpu")
    if case.startswith("csr"):
        from krylov_tpu_torch import parallel as tpar

        assert tpar.partition_csr(sp, 2)["mode"] == "halo"
        single = t_sparse.CSROperator.from_scipy(sp, device="cpu")
    else:
        single = A
    x = rng.standard_normal(sp.shape[0])
    out = pool.run(_spawn.apply_job, A, x, adjoint=True)
    if case.startswith("bsr"):
        route = case[4:]
        assert all(r["adjoint_paths"] == {route: 1} for r in out["per_rank"]), out["per_rank"]
    got = out["x"]
    _close(got, single.rmatvec(torch.from_numpy(x)).numpy(), RTOL[np.float64])
    _close(got, sp.T @ x, RTOL[np.float64])
