"""krylov_tpu_torch's stationary path held to krylov_tpu on the CPU:
``richardson``, ``jacobi``, ``gauss_seidel``, ``sor``, ``ssor``,
``SSORSmoother`` and the triangular sweeps of ``ops/triangular.py``.

* The twelve stationary entries of ``tests/fixtures/golden.json`` are
  replayed on both backends within ``test_golden.py``'s band (1e-11).
* The cases of ``tests/test_grid_sweeps.py`` run through both packages on
  the same inputs, made from a seed with numpy (float64).  Tolerances: the
  grid sweeps agree with the reference's within 1e-10 relative (measured
  ~1e-16: the within-row recurrence is summed by doubling steps here and by
  a work-efficient scan there, so the order of operations differs) and with
  scipy's sequential solve within 1e-12; the level-scheduled solves agree
  with the reference's and with scipy within rtol 1e-12 (the same sums in
  the same stored order).  The 100k-row case runs at 20k rows: above the
  8192-row dense cutoff, so it takes the level-scheduled route, and the
  reference's level pass stays under a second.
* One solve per solver and variant (blocked right-hand side, complex
  Hermitian matrix, custom inner product, unconverged) against the
  reference: equal ``numsteps`` and callback counts, histories within rtol
  1e-9, ``(None, info)`` when unconverged.
* ``SSORSmoother`` as ``M`` of ``cg`` and ``Ml`` of ``bicgstab`` on all
  three sweep routes against the reference's trajectory.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg as spla
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import stencil as jstencil
from krylov_tpu.ops import triangular as jtri
from krylov_tpu.solvers import stationary as jstat
from krylov_tpu_torch.ops import stencil as tstencil
from krylov_tpu_torch.ops import triangular as ttri
from krylov_tpu_torch.solvers import stationary as tstat

from .test_torch_gmres import assert_same, replay_golden
from .test_torch_twosided import BACKENDS, check_variant, golden_keys, problem

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

SOLVERS = ["richardson", "jacobi", "gauss_seidel", "sor", "ssor"]
STATIONARY_KEYS = golden_keys(*SOLVERS)


def test_the_twelve_golden_entries_are_found():
    assert len(STATIONARY_KEYS) == 12
    assert "richardson_w/spd5" in STATIONARY_KEYS
    assert "gauss_seidel_upper/sym6" in STATIONARY_KEYS


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("key", STATIONARY_KEYS)
def test_golden(key, backend):
    # "ssor" before "sor": the entry's name may carry a variant ("richardson_w")
    name = next(s for s in ("richardson", "jacobi", "gauss_seidel", "ssor", "sor")
                if key.startswith(s))
    replay_golden(key, getattr(kt, name), backend)


# ---------------------------------------------------------------------------
# the grid sweeps against the reference's and scipy's
# ---------------------------------------------------------------------------


def _pair(shape):
    """The same grid Laplacian in both packages."""
    make = "poisson_2d" if len(shape) == 2 else "poisson_3d"
    return getattr(jstencil, make)(*shape), getattr(tstencil, make)(*shape)


def _scipy_csr(A):
    c = A.tocsr()
    return scipy.sparse.csr_matrix(
        (np.asarray(c.data), np.asarray(c.indices), np.asarray(c.indptr)), shape=c.shape)


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("shape", [(8, 16), (6, 4, 8), (5, 7)])
def test_grid_sweep_matches_reference_and_scipy(shape, lower, omega):
    Aj, At = _pair(shape)
    M, ny = At.grid
    b = np.random.default_rng(0).standard_normal((M, ny))
    name = "grid_lower_sweep" if lower else "grid_upper_sweep"
    got = getattr(ttri, name)(At.coeffs2d, At.row_offsets, At.col_offsets,
                              torch.from_numpy(b), omega=omega).numpy()
    want = np.asarray(getattr(jtri, name)(Aj.coeffs2d, Aj.row_offsets, Aj.col_offsets,
                                          jnp.asarray(b), omega=omega))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)
    sp = _scipy_csr(Aj)
    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(sp, 0).tolil()
    tri.setdiag(sp.diagonal() / omega)
    exact = spla.spsolve_triangular(tri.tocsr(), b.reshape(-1), lower=lower)
    np.testing.assert_allclose(got.reshape(-1), exact, atol=1e-12)


def test_grid_sweep_batch_equals_one_pass_a_column():
    _, At = _pair((8, 16))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 8, 16)))
    for sweep in (ttri.grid_lower_sweep, ttri.grid_upper_sweep):
        both = sweep(At.coeffs2d, At.row_offsets, At.col_offsets, b, omega=1.2)
        for i in range(3):
            one = sweep(At.coeffs2d, At.row_offsets, At.col_offsets, b[i], omega=1.2)
            assert torch.equal(both[i], one)


def test_grid_sweep_keeps_the_reference_guards():
    _, At = _pair((4, 8))
    b = torch.ones(4, 8, dtype=torch.float64)
    no_diag = [d for d, (r, c) in enumerate(zip(At.row_offsets, At.col_offsets))
               if (r, c) != (0, 0)]
    with pytest.raises(ValueError, match="no diagonal band"):
        ttri.grid_lower_sweep(At.coeffs2d[no_diag],
                              [At.row_offsets[d] for d in no_diag],
                              [At.col_offsets[d] for d in no_diag], b)
    with pytest.raises(NotImplementedError, match="order 1"):
        ttri.grid_lower_sweep(At.coeffs2d[:2], (0, 0), (0, -2), b)
    # a zero on the diagonal leaves that point's a and c finite (d_row != 0 guard)
    coeffs = At.coeffs2d.clone()
    diag = [d for d, (r, c) in enumerate(zip(At.row_offsets, At.col_offsets))
            if (r, c) == (0, 0)][0]
    coeffs[diag, 1, 3] = 0.0
    out = ttri.grid_lower_sweep(coeffs, At.row_offsets, At.col_offsets, b)
    assert torch.isfinite(out).all()
    # complex right-hand side, real planes
    bc = torch.complex(b, 2 * b)
    out = ttri.grid_lower_sweep(At.coeffs2d, At.row_offsets, At.col_offsets, bc)
    real = ttri.grid_lower_sweep(At.coeffs2d, At.row_offsets, At.col_offsets, b)
    np.testing.assert_allclose(out.numpy(), (real + 2j * real).numpy(), rtol=1e-13)


SWEEP_SOLVERS = [("gauss_seidel", {}), ("gauss_seidel", {"lower": False}),
                 ("sor", {"omega": 1.4}), ("ssor", {"omega": 1.2})]


@functools.cache
def _reference_grid_solve(case, dense):
    name, kw = SWEEP_SOLVERS[case]
    Aj, _ = _pair((8, 16))
    b = jnp.asarray(np.random.default_rng(2).standard_normal(128))
    A = np.asarray(Aj.todense()) if dense else Aj
    # compiled: the reference's eager backend spends seconds in the sweeps' scans
    return getattr(krylov_tpu, name)(A, b, maxiter=20, tol=1e-30, backend="while_loop",
                                     **kw)[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(SWEEP_SOLVERS)))
def test_grid_sweep_solvers_match_dense_path(case, backend):
    name, kw = SWEEP_SOLVERS[case]
    _, At = _pair((8, 16))
    b = np.random.default_rng(2).standard_normal(128)
    sol, info = getattr(kt, name)(At, b, maxiter=20, tol=1e-30, backend=backend, **kw)
    sol_d, info_d = getattr(kt, name)(At.todense(), b, maxiter=20, tol=1e-30,
                                      backend=backend, **kw)
    assert sol is None and sol_d is None and info.numsteps == info_d.numsteps == 20
    np.testing.assert_allclose(info.resnorms, info_d.resnorms, rtol=1e-10, atol=1e-12)
    for dense, mine in ((False, info), (True, info_d)):
        assert_same(mine, _reference_grid_solve(case, dense), rtol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_grid_gs_converges_and_multi_rhs(backend):
    Aj, At = _pair((8, 8))
    rng = np.random.default_rng(3)
    b, B = rng.standard_normal(64), rng.standard_normal((64, 2))
    for rhs in (b, B):
        sol, info = kt.gauss_seidel(At, rhs, tol=1e-8, maxiter=2000, backend=backend)
        assert info.success and sol is not None
        ref = krylov_tpu.gauss_seidel(Aj, jnp.asarray(rhs), tol=1e-8, maxiter=2000,
                                      backend="while_loop")[1]
        assert_same(info, ref, rtol=1e-9)
    # grid-shaped vectors, with the full-contraction inner they need
    full = lambda x, y: (x.conj() * y).sum()  # noqa: E731
    sol, info = kt.gauss_seidel(At, b.reshape(8, 8), inner=full, tol=1e-8, maxiter=2000,
                                backend=backend)
    flat = kt.gauss_seidel(At, b, tol=1e-8, maxiter=2000, backend=backend)[1]
    assert info.success and tuple(sol.shape) == (8, 8)
    np.testing.assert_allclose(info.resnorms, flat.resnorms, rtol=1e-12)


# ---------------------------------------------------------------------------
# the level-scheduled sweeps
# ---------------------------------------------------------------------------


def _unstructured(n, k, scale, shift, seed, window=None):
    """A symmetric matrix whose strict lower triangle has ``k`` neighbours
    a row drawn from all earlier rows: dependency depth O(log n).  With
    ``window`` they come from the ``window`` rows just above: depth about
    ``2 n / window``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), k)
    span = rows if window is None else np.minimum(rows, window)
    cols = rows - 1 - (rng.random(rows.shape[0]) * span).astype(np.int64)
    vals = scale * rng.standard_normal(rows.shape[0])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(shift + rng.random(n))
    A.sum_duplicates()
    return A, rng.standard_normal(n)


def _scipy_trajectory(A, b, steps, lower=True):
    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(A).tocsr()
    x, r = np.zeros(len(b)), b.copy()
    out = [np.linalg.norm(r)]
    for _ in range(steps):
        x = x + spla.spsolve_triangular(tri, r, lower=lower)
        r = b - A @ x
        out.append(np.linalg.norm(r))
    return np.asarray(out)


@functools.cache
def _reference_level_gs():
    A, b = _unstructured(20_000, 4, 0.2, 4.0, 77)
    return krylov_tpu.gauss_seidel(A, jnp.asarray(b), tol=1e-6, maxiter=12,
                                   backend="while_loop")[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_level_scheduled_gs_matches_reference_and_scipy(backend):
    A, b = _unstructured(20_000, 4, 0.2, 4.0, 77)
    sol, info = kt.gauss_seidel(A, b, tol=1e-6, maxiter=12, backend=backend)
    assert info.success
    assert_same(info, _reference_level_gs(), rtol=1e-12)
    np.testing.assert_allclose(info.resnorms, _scipy_trajectory(A, b, info.numsteps),
                               rtol=1e-9, atol=1e-12)
    # a CSROperator above the cutoff takes the same route
    info_op = kt.gauss_seidel(kt.as_operator(A), b, tol=1e-6, maxiter=12, backend=backend)[1]
    np.testing.assert_array_equal(info_op.resnorms, info.resnorms)


@pytest.mark.parametrize("name", ["sor", "ssor"])
def test_level_scheduled_sor_ssor_large_sparse(name):
    A, b = _unstructured(9_000, 3, 0.15, 3.0, 78)
    sol, info = getattr(kt, name)(A, b, tol=1e-6, maxiter=40, backend="while_loop", omega=1.2)
    assert info.success, name
    r = b - A @ sol.numpy()
    assert np.linalg.norm(r) <= 1e-5 * (1 + np.linalg.norm(b))
    ref = getattr(krylov_tpu, name)(A, jnp.asarray(b), tol=1e-6, maxiter=40,
                                    backend="while_loop", omega=1.2)[1]
    assert_same(info, ref, rtol=1e-12)


def test_make_triangular_solve_deep_factor_uses_stacked_sweep():
    rng = np.random.default_rng(5)
    n = 300
    L = scipy.sparse.diags(
        [2.0 + rng.random(n), 0.3 * rng.standard_normal(n - 1)], [0, -1]).tocsr()
    solve = ttri.make_triangular_solve(L, lower=True)
    assert isinstance(solve, ttri.StackedTriangularSweep) and solve.nlevels == n
    b = rng.standard_normal((n, 2))
    want = spla.spsolve_triangular(L, b, lower=True)
    got = solve(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    ref = np.asarray(jtri.make_triangular_solve(L, lower=True)(jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)
    shallow = scipy.sparse.diags([2.0 + rng.random(16)], [0]).tocsr()
    assert isinstance(ttri.make_triangular_solve(shallow, lower=True),
                      ttri.LevelScheduledTriangularSolve)


@pytest.mark.parametrize("lower", [True, False])
def test_level_arrays_equal_the_reference(lower):
    A, _ = _unstructured(3_000, 3, 0.2, 4.0, 9)
    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(A).tocsr()
    n, levels = ttri.level_arrays(tri, lower=lower)
    n_ref, levels_ref = jtri.level_arrays(tri, lower=lower)
    assert n == n_ref and len(levels) == len(levels_ref)
    for mine, theirs in zip(levels, levels_ref):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    stacked = ttri.stacked_level_arrays([tri], n, lower=lower)
    for a, b in zip(stacked, jtri.stacked_level_arrays([tri], n, lower=lower)):
        np.testing.assert_array_equal(a, b)
    b = np.random.default_rng(10).standard_normal((n, 2))
    want = spla.spsolve_triangular(tri, b, lower=lower)
    for solve in (ttri.LevelScheduledTriangularSolve(tri, lower=lower),
                  ttri.StackedTriangularSweep(*(torch.from_numpy(a[0]) for a in stacked), n)):
        np.testing.assert_allclose(solve(torch.from_numpy(b)).numpy(), want,
                                   rtol=1e-12, atol=1e-13)


def test_level_arrays_refuses_deep_chains_and_zero_diagonals():
    n = 50
    chain = scipy.sparse.diags([np.ones(n), np.ones(n - 1)], [0, -1]).tocsr()
    with pytest.raises(NotImplementedError, match="dependency levels"):
        ttri.level_arrays(chain, lower=True, max_levels=10)
    assert len(ttri.level_arrays(chain, lower=True, max_levels=n)[1]) == n
    hole = scipy.sparse.diags([np.r_[np.ones(3), 0.0]], [0]).tocsr()
    with pytest.raises(ValueError, match="zeros on the diagonal"):
        ttri.level_arrays(hole)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gauss_seidel_deep_banded_sparse_matches_scipy(backend):
    rng = np.random.default_rng(6)
    n = 500
    A = scipy.sparse.diags(
        [0.45 * rng.standard_normal(n - 1), 2.0 + rng.random(n),
         0.45 * rng.standard_normal(n - 1)], [-1, 0, 1]).tocsr()
    b = rng.standard_normal(n)
    sol, info = kt.gauss_seidel(A, b, tol=1e-8, maxiter=60, backend=backend)
    assert info.success
    np.testing.assert_allclose(info.resnorms, _scipy_trajectory(A, b, info.numsteps),
                               rtol=1e-9, atol=1e-12)
    ref = krylov_tpu.gauss_seidel(A, jnp.asarray(b), tol=1e-8, maxiter=60,
                                  backend="while_loop")[1]
    assert_same(info, ref, rtol=1e-9)


def test_routes_by_operator_type(monkeypatch):
    """Grid stencils take the grid sweeps, sparse matrices above the cutoff
    the level-scheduled ones (the triangle taken from the matrix as passed
    in), everything else the dense solve."""
    _, At = _pair((8, 8))
    A, b = _unstructured(200, 3, 0.15, 3.0, 4)
    assert tstat._is_grid_stencil(At) and not tstat._is_grid_stencil(A)
    assert tstat._sparse_for_levels(A) is None
    monkeypatch.setattr(tstat, "_DENSE_SWEEP_MAX", 100)
    assert tstat._sparse_for_levels(A).shape == (200, 200)
    assert tstat._sparse_for_levels(kt.as_operator(A)).nnz == A.nnz
    level = kt.ssor(A, b, tol=1e-10, maxiter=50, omega=1.1)[1]
    monkeypatch.setattr(tstat, "_DENSE_SWEEP_MAX", 8192)
    dense = kt.ssor(A, b, tol=1e-10, maxiter=50, omega=1.1)[1]
    assert level.numsteps == dense.numsteps
    np.testing.assert_allclose(level.resnorms, dense.resnorms, rtol=1e-9, atol=1e-14)
    with pytest.raises(ValueError, match="need a matrix"):
        kt.gauss_seidel(kt.Product(kt.as_operator(np.eye(3))), np.ones(3))


# ---------------------------------------------------------------------------
# the solve loop's contract on every solver
# ---------------------------------------------------------------------------

# omega keeps richardson convergent on the shared problems (spectrum in [1, 3])
EXTRA = {"richardson": (("omega", 0.5),), "sor": (("omega", 1.2),), "ssor": (("omega", 1.2),)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", ["plain", "blocked", "complex", "inner", "unconverged"])
@pytest.mark.parametrize("name", SOLVERS)
def test_variants(name, variant, backend):
    check_variant(name, variant, "spd", (), backend, extra=EXTRA.get(name, ()))


@pytest.mark.parametrize("name", SOLVERS)
def test_backend_equivalence(name):
    """``tests/test_backends.py``'s stationary cases on the port."""
    from .test_backends import PROBLEMS

    A, b = PROBLEMS["spd"]
    runs = [getattr(kt, name)(np.asarray(A), np.asarray(b), tol=1e-7, maxiter=b.shape[0],
                              backend=backend)[1] for backend in BACKENDS]
    assert runs[0].success == runs[1].success and runs[0].numsteps == runs[1].numsteps
    np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
    ref = getattr(krylov_tpu, name)(A, b, tol=1e-7, maxiter=b.shape[0])[1]
    assert_same(runs[0], ref, rtol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compiled_callback_contract(backend):
    A = np.diag([1.0e-3] + list(range(2, 101)))
    b = np.ones(100)
    calls = []
    _, info = kt.jacobi(A, b, tol=1e-8, maxiter=200, backend=backend,
                        callback=lambda *a: calls.append(len(a)))
    assert len(calls) == info.numsteps + 1 and all(n == 2 for n in calls)


def test_x0_and_the_initial_residual():
    A, b, _ = problem("spd")
    x0 = np.random.default_rng(8).standard_normal(len(b))
    info = kt.gauss_seidel(A, b, x0=x0, tol=1e-9)[1]
    ref = krylov_tpu.gauss_seidel(A, jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-9)[1]
    assert_same(info, ref, rtol=1e-9)
    np.testing.assert_allclose(info.resnorms[0], np.linalg.norm(b - A @ x0), rtol=1e-13)


# ---------------------------------------------------------------------------
# SSORSmoother
# ---------------------------------------------------------------------------


def _smoother_case(route):
    """``(A for the reference, A for the port, b)`` on one sweep route."""
    rng = np.random.default_rng(12)
    if route == "grid":
        Aj, At = _pair((8, 16))
        return Aj, At, rng.standard_normal(128)
    if route == "level":
        # run with both packages' dense cutoff lowered to 100 rows; more than
        # 64 levels, so both take the stacked sweep (the reference compiles one
        # scan; its unrolled levels take half a minute to compile)
        A, b = _unstructured(400, 3, 0.15, 3.0, 13, window=6)
        return A, A, b
    A, b = _unstructured(120, 3, 0.15, 3.0, 14)
    return A, A, b


def _cutoff(mp, route):
    """Send the 400-row matrix of the ``level`` route to the level-scheduled
    sweeps in both packages."""
    if route == "level":
        mp.setattr(tstat, "_DENSE_SWEEP_MAX", 100)
        mp.setattr(jstat, "_DENSE_SWEEP_MAX", 100)


@functools.cache
def _reference_smoothed(route, solver):
    """The reference's preconditioned solve, compiled: its eager backend
    would trace the sweeps' scans anew at every application."""
    Aj, _, b = _smoother_case(route)
    with pytest.MonkeyPatch.context() as mp:
        _cutoff(mp, route)
        M = krylov_tpu.SSORSmoother(Aj, omega=1.2)
        assert route != "level" or M._fwd.nlevels > 64
    kw = {"M": M} if solver == "cg" else {"Ml": M}
    return getattr(krylov_tpu, solver)(Aj, jnp.asarray(b), tol=1e-9, maxiter=200,
                                       backend="while_loop", **kw)[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("route", ["grid", "level", "dense"])
def test_ssor_smoother_preconditions(route, solver, backend, monkeypatch):
    _, At, b = _smoother_case(route)
    _cutoff(monkeypatch, route)
    M = kt.SSORSmoother(At, omega=1.2)
    assert route != "level" or M._fwd.nlevels > 64
    assert M.dtype == torch.float64 and M.device.type == "cpu"
    kw = {"M": M} if solver == "cg" else {"Ml": M}
    sol, info = getattr(kt, solver)(At, b, tol=1e-9, maxiter=200, backend=backend, **kw)
    assert info.success
    plain = getattr(kt, solver)(At, b, tol=1e-9, maxiter=200, backend=backend)[1]
    assert info.numsteps < plain.numsteps
    assert_same(info, _reference_smoothed(route, solver), rtol=1e-8)


def test_ssor_smoother_is_one_ssor_update_and_self_adjoint():
    _, At, b = _smoother_case("dense")
    M = kt.SSORSmoother(At, omega=1.2)
    r = torch.from_numpy(b)
    info = kt.ssor(At, b, omega=1.2, maxiter=1, tol=1e-30)[1]
    np.testing.assert_allclose((M @ r).numpy(), info.xk.numpy(), rtol=1e-13)
    assert torch.equal(M.rmatvec(r), M @ r) and torch.equal(M.matvec(r), M @ r)
    s = torch.from_numpy(np.random.default_rng(15).standard_normal(len(b)))
    np.testing.assert_allclose(float(s @ (M @ r)), float((M @ s) @ r), rtol=1e-11)
