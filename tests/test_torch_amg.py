"""krylov_tpu_torch.AMGPreconditioner held to krylov_tpu.AMGPreconditioner
on the CPU.

The cases of ``tests/test_amg.py`` run through both packages on the same
inputs, made from a seed with numpy:

* the hierarchy: the labels, coarse sizes, every Galerkin level matrix, the
  ``lmax`` estimates, prolongator weights, Jacobi vectors and the coarse
  inverse equal the reference's bit for bit, in float64 and float32 (the
  same host code and the same native helpers);
* one V-cycle (Jacobi and Chebyshev smoothers, smoothed and unsmoothed
  prolongator, 1-D and ``(N, k)`` right-hand sides, the stalled-coarsening
  fallback, ``fine_operator=``) within rtol 1e-12 of the reference's, in
  float64;
* ``cg`` with AMG as ``M`` on both backends against the reference's solve:
  equal ``numsteps``, resnorms within rtol 1e-10;
* a float32 hierarchy on the CSR kernels' route (``PETOperator`` levels and
  prolongators, their plain versions here) held to the reference's float64
  trajectory within the port's 2e-3 band;
* the guards, ``from_reference``, and the reference's own properties
  (mesh-independent iteration counts, anisotropy, coefficient jumps, a
  symmetric positive cycle).
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import amg as jamg
from krylov_tpu_torch import _operators
from krylov_tpu_torch import amg as tamg
from krylov_tpu_torch.ops.cuda_spmv import PETOperator
from krylov_tpu_torch.ops.sparse import CSROperator

from .test_torch_gmres import assert_same

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

BACKENDS = ["eager", "while_loop"]


def poisson2d_csr(nx, ny=None, eps=1.0):
    ny = nx if ny is None else ny
    Tx = scipy.sparse.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)], [-1, 0, 1])
    Ty = scipy.sparse.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)], [-1, 0, 1])
    return (scipy.sparse.kron(scipy.sparse.eye(ny), Tx)
            + eps * scipy.sparse.kron(Ty, scipy.sparse.eye(nx))).tocsr()


def jumps(n=32):
    """Poisson with 3-decade coefficient jumps: D^1/2 A D^1/2."""
    d = np.exp(3 * np.random.default_rng(4).standard_normal(n * n))
    Dh = scipy.sparse.diags(np.sqrt(d))
    return (Dh @ poisson2d_csr(n) @ Dh).tocsr()


def stalled(n=6000):
    """Diagonally dominant: an empty strength graph, so coarsening stalls at
    level 0 far above the dense-inverse limit."""
    return scipy.sparse.diags([0.01 * np.ones(n - 1), np.arange(1.0, n + 1),
                               0.01 * np.ones(n - 1)], [-1, 0, 1], format="csr")


def hermitian(n=128):
    rng = np.random.default_rng(5)
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return scipy.sparse.csr_matrix(np.eye(n) * 12.0 + 0.5 * (C + C.conj().T))


CASES = {
    "poisson": (lambda: poisson2d_csr(32), {}),
    "aniso": (lambda: poisson2d_csr(48, eps=0.01), dict(theta=0.2)),
    "jumps": (jumps, {}),
    "jumps gershgorin": (jumps, dict(lmax_method="gershgorin")),
    "unsmoothed": (lambda: poisson2d_csr(32), dict(smooth_prolongator=False)),
    "high spectrum": (lambda: scipy.sparse.csr_matrix(np.ones((300, 300)) + 10.0 * np.eye(300)),
                      dict(coarse_size=50)),
    "diagonal": (lambda: scipy.sparse.diags(1.0 + np.arange(500.0)).tocsr(),
                 dict(coarse_size=100)),
    "stalled": (stalled, {}),
    "hermitian": (hermitian, dict(coarse_size=16)),
}


def _pair(case, dtype=None, **extra):
    make, kw = CASES[case]
    A = make()
    kw = dict(kw, **extra)
    if dtype is not None:
        kw["dtype"] = dtype
    return (A, kt.AMGPreconditioner.from_scipy(A, **kw),
            krylov_tpu.AMGPreconditioner.from_scipy(A, **kw))


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_operator(t, j):
    """A port level operator carries the reference's arrays exactly."""
    assert isinstance(t, CSROperator) and type(j).__name__ == "CSROperator"
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(_host(getattr(t, name)), np.asarray(getattr(j, name)))
    assert t.shape == tuple(j.shape)


@pytest.mark.parametrize("case,dtype", [(c, None) for c in sorted(CASES)] + [
    (c, np.float32) for c in sorted(CASES) if c != "hermitian"])
def test_hierarchy_equals_reference(case, dtype):
    A, Mt, Mj = _pair(case, dtype)
    assert Mt.level_sizes == Mj.level_sizes and Mt.n_levels == Mj.n_levels
    assert Mt.shape == Mj.shape and Mt.hermitian
    assert Mt._lmaxs == Mj._lmaxs and Mt._p_w == Mj._p_w and Mt._jw == Mj._jw
    for ops_t, ops_j in ((Mt._ops, Mj._ops), (Mt._phats, Mj._phats)):
        assert len(ops_t) == len(ops_j)
        for t, j in zip(ops_t, ops_j):
            _same_operator(t, j)
    for t, j in zip(Mt._dinvs, Mj._dinvs):
        np.testing.assert_array_equal(_host(t), np.asarray(j))
    for name in ("_coarse_inv", "_coarse_dinv"):
        t, j = getattr(Mt, name), getattr(Mj, name)
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(_host(t), np.asarray(j))
    assert (Mt._coarse_op is None) == (Mj._coarse_op is None)
    if Mt._coarse_op is not None:
        _same_operator(Mt._coarse_op, Mj._coarse_op)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_labels_and_galerkin_levels_equal_reference(dtype):
    """Level by level through the set-up's own steps: the same aggregates
    and bit for bit the same coarse matrices."""
    Al = jumps(48).astype(dtype)
    Al.sort_indices()
    for _ in range(3):
        lt, nt = tamg._aggregate(Al, 0.08)
        lj, nj = jamg._aggregate(Al, 0.08)
        assert nt == nj
        np.testing.assert_array_equal(lt, lj)
        _, Act, lmt, _, _ = tamg._smoothed_prolongator(Al, 0.08, True, need_P=False)
        _, Acj, lmj, _, _ = jamg._smoothed_prolongator(Al, 0.08, True, need_P=False)
        assert lmt == lmj and Act.dtype == Acj.dtype == dtype
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(Act, name), getattr(Acj, name))
        # the scipy triple product (need_P) is the native one's ground truth
        P, Acs, _, _, _ = tamg._smoothed_prolongator(Al, 0.08, True, need_P=True)
        assert P.shape == (Al.shape[0], nt)
        tol = 1e-5 if dtype == np.float32 else 1e-13
        assert abs(Acs - Act).max() <= tol * abs(Acs).max()
        Al = Act


def _cycle_inputs(n, k=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k))


@pytest.mark.parametrize("rhs", [None, 3])
@pytest.mark.parametrize("smooth_prolongator", [True, False])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_matches_reference(smoother, smooth_prolongator, rhs):
    _, Mt, Mj = _pair("jumps", smoother=smoother, smooth_prolongator=smooth_prolongator)
    r = _cycle_inputs(Mt.shape[0], rhs)
    got = Mt @ torch.from_numpy(r)
    assert got.shape == r.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(Mj @ r), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(Mj @ r)).max())
    np.testing.assert_array_equal(Mt.rmatvec(torch.from_numpy(r)).numpy(), got.numpy())


@pytest.mark.parametrize("case", ["stalled", "diagonal", "high spectrum", "hermitian", "aniso"])
def test_vcycle_matches_reference_on_every_route(case):
    _, Mt, Mj = _pair(case)
    if case == "stalled":
        assert Mt._coarse_inv is None and Mt._coarse_op is not None
    r = _cycle_inputs(Mt.shape[0], seed=1)
    if case == "hermitian":
        r = r + 1j * _cycle_inputs(Mt.shape[0], seed=2)
    want = np.asarray(Mj @ r)
    np.testing.assert_allclose((Mt @ torch.from_numpy(r)).numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_fine_operator_reuse_identical_cycle():
    """``fine_operator=`` is level 0 by identity, and the cycle is the
    self-built hierarchy's bit for bit (the same matrix, the same matvecs)."""
    n_side = 40
    n = n_side * n_side
    A = scipy.sparse.diags([-1.0, -1.0, 4.0, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
                           shape=(n, n), format="csr")
    op = CSROperator.from_scipy(A)
    M0 = kt.AMGPreconditioner.from_scipy(A)
    M1 = kt.AMGPreconditioner.from_scipy(A, fine_operator=op)
    assert M1._ops[0] is op and M1.level_sizes == M0.level_sizes
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(n))
    assert torch.equal(M1 @ r, M0 @ r)
    Mj = krylov_tpu.AMGPreconditioner.from_scipy(
        A, fine_operator=krylov_tpu.ops.sparse.CSROperator.from_scipy(A))
    np.testing.assert_allclose((M1 @ r).numpy(), np.asarray(Mj @ r.numpy()), rtol=1e-12,
                               atol=1e-13)
    _, i0 = kt.cg(A, r, M=M0, tol=1e-10, backend="while_loop")
    _, i1 = kt.cg(A, r, M=M1, tol=1e-10, backend="while_loop")
    assert i0.numsteps == i1.numsteps
    np.testing.assert_array_equal(i0.resnorms, i1.resnorms)


@functools.cache
def _reference(case):
    """The reference's solve of one case, shared by both backends' tests."""
    if case == "cg":
        A = poisson2d_csr(48)
        M = krylov_tpu.AMGPreconditioner.from_scipy(A)
        return krylov_tpu.cg(A, _cycle_inputs(48 * 48, seed=3), M=M, tol=1e-9, maxiter=100)[1]
    if case == "chebyshev":
        A = jumps()
        M = krylov_tpu.AMGPreconditioner.from_scipy(A, smoother="chebyshev")
        return krylov_tpu.cg(A, _cycle_inputs(32 * 32, seed=4), M=M, tol=1e-8,
                             maxiter=400)[1]
    if case == "blocked":
        A = poisson2d_csr(48)
        M = krylov_tpu.AMGPreconditioner.from_scipy(A)
        return krylov_tpu.cg(A, _cycle_inputs(48 * 48, 3, seed=5), M=M, tol=1e-8,
                             maxiter=100)[1]
    A = poisson2d_csr(256)  # 65,536 rows: every large level and P_hat on the PET route
    M = krylov_tpu.AMGPreconditioner.from_scipy(A)
    return krylov_tpu.cg(A, _cycle_inputs(256 * 256, seed=6), M=M, tol=1e-3, maxiter=100,
                         backend="while_loop")[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["cg", "chebyshev", "blocked"])
def test_cg_trajectory_matches_reference(case, backend):
    if case == "chebyshev":
        A, n, kw, b = jumps(), 32, dict(tol=1e-8, maxiter=400), _cycle_inputs(32 * 32, seed=4)
        M = kt.AMGPreconditioner.from_scipy(A, smoother="chebyshev")
    else:
        A, n, kw = poisson2d_csr(48), 48, dict(tol=1e-9 if case == "cg" else 1e-8, maxiter=100)
        b = _cycle_inputs(n * n, seed=3) if case == "cg" else _cycle_inputs(n * n, 3, seed=5)
        M = kt.AMGPreconditioner.from_scipy(A)
    sol, info = kt.cg(A, torch.from_numpy(b), M=M, backend=backend, **kw)
    assert info.success
    assert_same(info, _reference(case))
    R = b - A @ sol.numpy()
    # cg converges in the M-norm: with 3-decade coefficient jumps the
    # Euclidean residual is a few orders looser (the reference's bound)
    bound = 1e-4 if case == "chebyshev" else 1e-7
    assert np.linalg.norm(R) <= bound * (1 + np.linalg.norm(b))


def test_float32_on_the_csr_kernels_route():
    """A float32 hierarchy with ``_pet_device`` on: the fine and large coarse
    levels become ``PETOperator`` (reordered where the reference's fill rule
    says so), the first prolongator a ``PETOperator`` with its adjoint
    built; ``cg`` is held to the reference's float64 trajectory: every
    resnorm within 2e-3 relative, numsteps within one."""
    A = poisson2d_csr(256)
    A32 = A.astype(np.float32)
    b = _cycle_inputs(256 * 256, seed=6)
    ref = _reference("pet")
    with mock.patch.object(_operators, "_pet_device", lambda device: True):
        op = kt.as_operator(A32)
        assert isinstance(op, PETOperator)
        M = kt.AMGPreconditioner.from_scipy(A32, dtype=np.float32, fine_operator=op)
        kinds = [type(o).__name__ for o in M._ops], [type(p).__name__ for p in M._phats]
        assert kinds[0][:3] == ["PETOperator"] * 3 and kinds[1][0] == "PETOperator", kinds
        assert M._phats[0]._csr_t is not None and M.dtype == torch.float32
        # 1e-3: the last entry is the explicit residual, which float32
        # rounds at ~3e-5 here (1e-7 of |b| = 210)
        _, info = kt.cg(A32, torch.from_numpy(b.astype(np.float32)), M=M, tol=1e-3,
                        maxiter=100, backend="while_loop")
        # a blocked right-hand side takes K11's route through every level
        B = torch.from_numpy(_cycle_inputs(256 * 256, 2, seed=7).astype(np.float32))
        Z = M @ B
        for j in range(2):
            torch.testing.assert_close(Z[:, j], M @ B[:, j].contiguous(), rtol=1e-5, atol=1e-5)
    assert info.success and abs(info.numsteps - int(ref.numsteps)) <= 1
    n = min(len(info.resnorms), len(ref.resnorms))
    want = np.asarray(ref.resnorms)[:n]
    assert np.max(np.abs(info.resnorms[:n] - want) / want) <= 2e-3


def test_pet_adjoint_of_a_rectangular_matrix():
    """``PETOperator.rmatvec`` takes a vector of the matrix's row count (the
    restriction of a tentative prolongator is one)."""
    P = scipy.sparse.random(300, 70, density=0.05, format="csr", random_state=3,
                            dtype=np.float32)
    op = PETOperator.from_scipy(P, with_rmatvec=True)
    d = np.random.default_rng(8).standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(op.rmatvec(torch.from_numpy(d)).numpy(), P.T @ d, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="adjoint"):
        op.rmatvec(torch.zeros(70))


def test_mesh_independence_and_iteration_collapse():
    iters = {}
    rng = np.random.default_rng(11)
    for n in (32, 64, 128):
        A = poisson2d_csr(n)
        b = torch.from_numpy(rng.standard_normal(n * n))
        sol, info = kt.cg(A, b, M=kt.AMGPreconditioner.from_scipy(A), tol=1e-8, maxiter=300,
                          backend="while_loop")
        assert info.success
        iters[n] = info.numsteps
    assert iters[128] <= 20 and iters[128] <= iters[32] + 6
    _, plain = kt.cg(A, b, tol=1e-8, maxiter=2000, backend="while_loop")
    assert iters[128] * 10 <= plain.numsteps


def test_anisotropy_jumps_and_other_solvers():
    rng = np.random.default_rng(12)
    A = poisson2d_csr(96, eps=0.01)
    _, info = kt.cg(A, torch.from_numpy(rng.standard_normal(96 * 96)),
                    M=kt.AMGPreconditioner.from_scipy(A, theta=0.2), tol=1e-8, maxiter=300,
                    backend="while_loop")
    assert info.success and info.numsteps <= 40
    Aj = jumps(64)
    b = torch.from_numpy(rng.standard_normal(64 * 64))
    M = kt.AMGPreconditioner.from_scipy(Aj)
    _, info = kt.cg(Aj, b, M=M, tol=1e-8, maxiter=300, backend="while_loop")
    assert info.success and info.numsteps <= 120
    _, plain = kt.cg(Aj, b, tol=1e-8, maxiter=300, backend="while_loop")
    assert not plain.success
    A = poisson2d_csr(48)
    M = kt.AMGPreconditioner.from_scipy(A)
    b = torch.from_numpy(rng.standard_normal(48 * 48))
    assert kt.minres(A, b, M=M, tol=1e-8, maxiter=100)[1].success
    _, info = kt.bicgstab(A, b, Ml=M, tol=1e-8, maxiter=100)
    assert info.success and info.numsteps <= 15


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_cycle_is_symmetric_positive(smoother):
    A = poisson2d_csr(32)
    M = kt.AMGPreconditioner.from_scipy(A, smoother=smoother)
    rng = np.random.default_rng(13)
    u, v = (torch.from_numpy(rng.standard_normal(32 * 32)) for _ in range(2))
    a, c = float(u @ (M @ v)), float((M @ u) @ v)
    assert abs(a - c) <= 1e-10 * max(abs(a), abs(c)) and float(u @ (M @ u)) > 0


def test_setup_seconds_and_profile(monkeypatch, capsys):
    monkeypatch.setenv("KRYLOV_TORCH_AMG_PROFILE", "1")
    M = kt.AMGPreconditioner.from_scipy(poisson2d_csr(32))
    assert len(M.setup_seconds) == 3 and all(t >= 0 for t in M.setup_seconds.values())
    assert capsys.readouterr().err.count("[amg-setup]") == 3


@pytest.mark.parametrize("case", ["jumps", "stalled", "unsmoothed"])
def test_from_reference(case):
    _, _, Mj = _pair(case, smoother="chebyshev" if case == "jumps" else "jacobi")
    Mt = kt.convert.from_reference(Mj)
    assert isinstance(Mt, kt.AMGPreconditioner) and Mt.level_sizes == Mj.level_sizes
    assert Mt.smoother == Mj.smoother and Mt._p_w == Mj._p_w
    r = _cycle_inputs(Mt.shape[0], 2, seed=9)
    want = np.asarray(Mj @ jnp.asarray(r))
    np.testing.assert_allclose((Mt @ torch.from_numpy(r)).numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_guards():
    with pytest.raises(ValueError, match="square"):
        kt.AMGPreconditioner.from_scipy(scipy.sparse.random(10, 7, density=0.5, format="csr"))
    with pytest.raises(ValueError, match="smoother"):
        kt.AMGPreconditioner.from_scipy(poisson2d_csr(8), smoother="sor")
    with pytest.raises(ValueError, match="lmax_method"):
        kt.AMGPreconditioner.from_scipy(poisson2d_csr(8), lmax_method="exact", coarse_size=10)
