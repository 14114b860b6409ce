"""krylov_tpu_torch.fgmres, cg_pipelined, cg_block and refine held to
krylov_tpu on the CPU.

None of the four has an entry in ``tests/fixtures/golden.json``: they take
the problems of the reference's own tests (``tests/test_fgmres.py``,
``test_pipelined.py``, ``test_block_cg.py``, ``test_refine.py``) at their
sizes, each against the properties those tests hold and against the
reference package on the same seeded inputs, and the shared sweep's
well-conditioned systems for step-by-step agreement (float64; ``numsteps``,
callback count, history within rtol 1e-9, solution).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import stencil as js
from krylov_tpu_torch import _operators as t_ops
from krylov_tpu_torch.ops import stencil as ts
from krylov_tpu_torch.ops.cuda_spmv import PETOperator

from .test_torch_gmres import assert_same
from .test_torch_twosided import BACKENDS, VARIANTS, check_variant, variant_args

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["cg_block", "cg_pipelined"])
def test_matches_reference(name, variant, backend):
    check_variant(name, variant, "spd", ("M",), backend)


# --- fgmres (a host loop: no backend argument) -------------------------------


def _unsym(n=80, seed=0):
    rng = np.random.default_rng(seed)
    return (np.diag(np.linspace(1.0, 60.0, n)) + 0.4 * rng.standard_normal((n, n)),
            rng.standard_normal(n))


def test_fgmres_matches_reference_and_gmres():
    A, b = _unsym()
    calls = []
    sol, info = kt.fgmres(A, b, tol=1e-10, maxiter=80, callback=lambda *a: calls.append(1))
    _, info_j = krylov_tpu.fgmres(A, b, tol=1e-10, maxiter=80)
    assert info.success and len(calls) == info.numsteps + 1
    assert_same(info, info_j, rtol=1e-9)
    # without M it is GMRES: the trajectories coincide
    _, info_g = kt.gmres(A, b, tol=1e-10, maxiter=80)
    m = min(len(info.resnorms), len(info_g.resnorms))
    np.testing.assert_allclose(info.resnorms[:m], info_g.resnorms[:m], rtol=1e-8,
                               atol=1e-13)
    np.testing.assert_allclose(A @ sol.numpy(), b, atol=1e-8)


def test_fgmres_with_an_inner_cg_preconditioner():
    """The flexible capability: an iterative solver as the preconditioner,
    another operator every iteration."""
    n = 256
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    At, Aj = ts.poisson_2d(16, 16), js.poisson_2d(16, 16)

    def inner_cg(lib, A):
        return lambda v: lib.cg(A, v, tol=1e-2, maxiter=8)[1].xk

    sol, info = kt.fgmres(At, b, M=inner_cg(kt, At), tol=1e-8, maxiter=60)
    _, info_j = krylov_tpu.fgmres(Aj, b, M=inner_cg(krylov_tpu, Aj), tol=1e-8, maxiter=60)
    _, info_plain = kt.fgmres(At, b, tol=1e-8, maxiter=200)
    assert info.success and info.numsteps * 3 <= info_plain.numsteps
    # the inner solves stop on a tolerance, so rounding may move a step
    assert_same(info, info_j, rtol=1e-6)
    r = b - (At @ sol).numpy()
    assert np.linalg.norm(r) <= 1e-6 * (1 + np.linalg.norm(b))


def test_fgmres_restarted_with_an_indexed_preconditioner():
    A, b = _unsym(60, 2)
    d = np.abs(np.diag(A)) + 1.0

    def M(xp):
        def apply(j, v):  # iteration-indexed preconditioner
            return xp(1.0 / d if j % 2 == 0 else 1.0 / np.sqrt(d)) * v
        return apply

    sol, info = kt.fgmres(A, b, M=M(torch.from_numpy), tol=1e-8, restart=15, maxiter=300)
    _, info_j = krylov_tpu.fgmres(A, b, M=M(jnp.asarray), tol=1e-8, restart=15, maxiter=300)
    assert info.success
    assert_same(info, info_j, rtol=1e-8)
    assert np.linalg.norm(b - A @ sol.numpy()) <= 1e-6 * (1 + np.linalg.norm(b))


@pytest.mark.parametrize("variant", ["complex", "inner", "precond"])
def test_fgmres_variants_match_reference(variant):
    """A complex matrix, the weighted inner product and a fixed Jacobi
    operator as M, against the reference (rtol 1e-9)."""
    A, b, kwargs_for = variant_args(variant, "nonsym", ("M",))
    sol, info = kt.fgmres(A, b, **kwargs_for(torch))
    _, info_j = krylov_tpu.fgmres(A, b, **kwargs_for(jnp))
    assert info.success and tuple(sol.shape) == b.shape
    assert_same(info, info_j, rtol=1e-9)


def test_fgmres_unconverged_and_errors():
    A, b = _unsym(40, 3)
    sol, info = kt.fgmres(A, b, tol=1e-14, maxiter=3)
    sol_j, info_j = krylov_tpu.fgmres(A, b, tol=1e-14, maxiter=3)
    assert sol is None and sol_j is None and not info.success
    assert len(info.resnorms) == info.numsteps + 1 == 4
    assert_same(info, info_j, rtol=1e-9)
    with pytest.raises(ValueError, match="single right-hand side"):
        kt.fgmres(A, np.ones((40, 2)))


# --- cg_pipelined: the reference's own problems ------------------------------


def _spd(n=60, seed=0):
    Q = np.random.default_rng(seed).standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipelined_follows_cg(backend):
    A = _spd()
    b = np.random.default_rng(1).standard_normal(60)
    sol, info = kt.cg_pipelined(A, b, tol=1e-10, maxiter=120, backend=backend)
    sol_c, info_c = kt.cg(A, b, tol=1e-10, maxiter=120)
    _, info_j = krylov_tpu.cg_pipelined(A, b, tol=1e-10, maxiter=120)
    assert info.success and abs(info.numsteps - info_c.numsteps) <= 3
    np.testing.assert_allclose(sol.numpy(), sol_c.numpy(), rtol=1e-7, atol=1e-9)
    # the recurred norm rr - 2 alpha rs + alpha^2 ss cancels near
    # convergence, so the tail of the history carries rounding: rtol 1e-6
    assert_same(info, info_j, rtol=1e-6)


def test_pipelined_preconditioned():
    n = 80
    d = np.linspace(1.0, 500.0, n)
    rng = np.random.default_rng(2)
    A = np.diag(d) + 0.01 * rng.standard_normal((n, n))
    A = (A + A.T) / 2
    b = rng.standard_normal(n)
    sol, info = kt.cg_pipelined(A, b, M=np.diag(1.0 / d), tol=1e-9, maxiter=n)
    _, info_n = kt.cg_pipelined(A, b, tol=1e-9, maxiter=n)
    assert info.success and info.numsteps <= info_n.numsteps
    assert np.linalg.norm(b - A @ sol.numpy()) <= 1e-7 * (1 + np.linalg.norm(b))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipelined_residual_replacement(backend):
    """The periodic explicit replacement keeps the reported and the true
    residual together at convergence; it fires at the reference's steps."""
    A = _spd(100, 5)
    b = np.random.default_rng(6).standard_normal(100)
    applies = []

    class Counting:
        shape, dtype = A.shape, torch.float64

        def __matmul__(self, x):
            applies.append(1)
            return torch.from_numpy(A) @ x

        rmatvec = __matmul__

    sol, info = kt.cg_pipelined(Counting(), b, tol=1e-11, maxiter=400, replace_every=5,
                                backend=backend)
    _, info_j = krylov_tpu.cg_pipelined(A, b, tol=1e-11, maxiter=400, replace_every=5)
    assert info.success and info.numsteps == info_j.numsteps
    assert np.linalg.norm(b - A @ sol.numpy()) <= 1e-9 * (1 + np.linalg.norm(b))
    # 2 set-up products, one per step, three more at every fifth step, and
    # one explicit residual per convergence event (at least one)
    k = info.numsteps
    assert len(applies) >= 2 + k + 3 * (k // 5) + 1


def test_pipelined_fused_inner_is_one_call_per_step():
    A = _spd(40, 3)
    b = np.random.default_rng(4).standard_normal(40)
    calls = []

    def fused(pairs):
        calls.append(len(pairs))
        return tuple(torch.sum(u.conj() * v, dim=0) for u, v in pairs)

    sol, info = kt.cg_pipelined(A, b, fused_inner=fused, tol=1e-9, maxiter=80,
                                backend="while_loop")
    assert info.success
    assert calls.count(8) == info.numsteps and set(calls) == {2, 8}


# --- cg_block: the reference's own problems ----------------------------------


def _outlier_spd(n=100):
    return np.diag([1e-3, 2e-3, 5e-3] + list(np.linspace(1.0, 10.0, n - 3)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_block_cg_beats_columnwise_on_outlier_spectrum(backend):
    A = _outlier_spd()
    B = np.random.default_rng(0).standard_normal((100, 3))
    sol, info = kt.cg_block(A, B, tol=1e-9, maxiter=200, backend=backend)
    _, info_c = kt.cg(A, B, tol=1e-9, maxiter=400)
    _, info_j = krylov_tpu.cg_block(A, B, tol=1e-9, maxiter=200)
    # the 3-column block absorbs the 3 outlier eigenvalues
    assert info.success and info_c.success and info.numsteps < info_c.numsteps
    assert info.resnorms.shape == (info.numsteps + 1, 3)
    assert np.max(np.linalg.norm(B - A @ sol.numpy(), axis=0)) <= 1e-7
    # cond(A) = 1e4 amplifies rounding in the k x k solves: rtol 1e-6
    assert_same(info, info_j, rtol=1e-6)


def test_block_cg_single_rhs_and_preconditioned():
    A = _outlier_spd(60)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(60)
    sol, info = kt.cg_block(A, b, tol=1e-9, maxiter=200)
    assert info.success and tuple(sol.shape) == (60,)
    assert info.resnorms.shape == (info.numsteps + 1,)
    B = rng.standard_normal((60, 2))
    _, info_p = kt.cg_block(A, B, M=np.diag(1.0 / np.diag(A)), tol=1e-9, maxiter=200)
    _, info_n = kt.cg_block(A, B, tol=1e-9, maxiter=200)
    assert info_p.success and info_p.numsteps <= info_n.numsteps


def test_block_cg_complex_hpd():
    """The relative ridge must not create an absolute accuracy floor."""
    rng = np.random.default_rng(9)
    n = 40
    Q = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = Q @ Q.conj().T + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    B = np.stack([b, b[::-1]], axis=1)
    sol, info = kt.cg_block(A, B, tol=1e-10, maxiter=120)
    assert info.success
    assert np.max(np.abs(B - A @ sol.numpy())) <= 1e-8


@pytest.mark.parametrize("backend", BACKENDS)
def test_block_cg_f32_dependent_columns_and_restart(backend):
    """In float32 the ridge scales with the dtype's epsilon: identical
    columns (a rank-1 block) give no NaN; with ``replace_every=30`` the
    explicit restart runs inside the solve, which then takes 42 steps as the
    reference's does."""
    A = _outlier_spd(48).astype(np.float32)
    col = np.random.default_rng(12).standard_normal(48).astype(np.float32)
    B = np.stack([col, col], axis=1)
    sol, info = kt.cg_block(A, B, tol=1e-4, maxiter=200, replace_every=30, backend=backend)
    _, info_j = krylov_tpu.cg_block(jnp.asarray(A), jnp.asarray(B), tol=1e-4, maxiter=200,
                                    replace_every=30)
    assert info.success and bool(torch.isfinite(info.xk).all())
    assert info.numsteps == int(info_j.numsteps) > 30
    assert info.xk.dtype == torch.float32
    assert np.max(np.linalg.norm(B - A @ info.xk.numpy(), axis=0)) <= 1e-2


def test_block_cg_grid_shaped_columns():
    """An operator-native ``(M, ny, k)`` block on a grid stencil."""
    At, Aj = ts.poisson_2d(8, 12), js.poisson_2d(8, 12)
    B = np.random.default_rng(3).standard_normal((8, 12, 2))
    full = lambda x, y: (x.conj() * y).sum((0, 1))  # noqa: E731
    sol, info = kt.cg_block(At, B, inner=full, tol=1e-9, backend="while_loop")
    _, info_j = krylov_tpu.cg_block(Aj, B, inner=full, tol=1e-9)
    assert info.success and tuple(sol.shape) == (8, 12, 2)
    assert_same(info, info_j, rtol=1e-8)


# --- refine: the reference's own problems ------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_refine_plain_restarts_to_tolerance(backend):
    At, Aj = ts.poisson_2d(8, 16), js.poisson_2d(8, 16)
    b = np.random.default_rng(0).standard_normal(128)
    kw = dict(inner_tol=1e-1, inner_maxiter=20, tol=1e-10, maxiter=60, backend=backend)
    sol, info = kt.refine(At, b, **kw)
    _, info_j = krylov_tpu.refine(Aj, b, **kw)
    assert info.success
    assert_same(info, info_j, rtol=1e-8)
    r = b - (At @ sol).numpy()
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(b))
    assert info.resnorms[-1] <= 1e-10 * info.resnorms[0] + 1e-15


def test_refine_bf16_inner_operator_reaches_f32_accuracy():
    """float32 working precision, bf16 inner operator: accuracy beyond
    what a pure-bf16 solve reaches."""
    A32 = ts.poisson_2d_const(16, 16, dtype=np.float32)
    A16 = ts.ConstStencilOperator((16, 16), A32.offsets_nd, A32.weights, torch.bfloat16)
    b = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    sol, info = kt.refine(A32, b, A_low=A16, inner_tol=5e-2, inner_maxiter=60,
                          tol=1e-5, maxiter=60)
    assert info.success and sol.dtype == torch.float32
    rel = np.linalg.norm(b - (A32 @ sol).numpy()) / np.linalg.norm(b)
    assert rel <= 2e-5
    _, info16 = kt.cg(A16, torch.from_numpy(b).bfloat16(), tol=1e-5, maxiter=1000,
                      backend="while_loop")
    r16 = b - (A32 @ info16.xk.float()).numpy()
    assert np.linalg.norm(r16) / np.linalg.norm(b) > rel


def _shifted_laplacian(n_side):
    n = n_side * n_side
    return scipy.sparse.diags(
        [-1.0, -1.0, 4.5, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
        shape=(n, n), format="csr",
    ).astype(np.float32)


def test_refine_with_a_bf16_pet_inner_operator():
    """The intended pairing: float32 residuals against the exact operator,
    inner solves through the CSR kernel with a bf16 value stream (its plain
    version on the CPU); the defect correction recovers float32 accuracy."""
    sp = _shifted_laplacian(40)
    A16 = PETOperator.from_scipy(sp, data_dtype=torch.bfloat16, with_rmatvec=False)
    b = np.random.default_rng(0).standard_normal(1600).astype(np.float32)
    sol, info = kt.refine(sp, b, A_low=A16, inner_tol=1e-2, inner_maxiter=100,
                          tol=1e-5, maxiter=20, backend="while_loop")
    assert info.success and info.numsteps <= 6  # the bf16 inner solve still contracts
    r = b - sp @ info.xk.numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5


def test_refine_routes_a_large_matrix_to_the_csr_kernel(monkeypatch):
    """With the device reporting the CSR kernels (rehearsed on the CPU), a
    large float32 scipy matrix given to refine is routed to PETOperator for
    the residuals as well."""
    monkeypatch.setattr(t_ops, "_pet_device", lambda device: True)
    sp = _shifted_laplacian(120)  # 71,520 stored entries, above the 2^16 gate
    assert type(kt.as_operator(sp)).__name__ == "PETOperator"
    A16 = PETOperator.from_scipy(sp, data_dtype=torch.bfloat16, with_rmatvec=False)
    b = np.random.default_rng(2).standard_normal(sp.shape[0]).astype(np.float32)
    sol, info = kt.refine(sp, b, A_low=A16, inner_tol=1e-2, inner_maxiter=100,
                          tol=1e-5, maxiter=20)
    assert info.success
    assert np.linalg.norm(b - sp @ sol.numpy()) / np.linalg.norm(b) < 1e-5
