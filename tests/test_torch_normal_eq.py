"""krylov_tpu_torch.cgne, cgnr and lsqr held to krylov_tpu on the CPU.

Every ``cgne*`` and ``cgnr*`` entry of ``tests/fixtures/golden.json`` is
replayed through the port on both backends within ``test_golden.py``'s
bands (``LOOSE_CASES`` included), and the variants of the shared sweep are
compared with the reference package (float64, rtol 1e-9).  ``lsqr`` has no
golden entries: it takes the problems of the reference's
``tests/test_lsqr.py`` at their sizes (square, over- and underdetermined,
damped, sparse, blocked, complex, warm start, unconverged, zero
right-hand side), each against a direct solve and the reference package,
and the sweep's well-conditioned systems for step-by-step agreement.
"""

import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt

from .test_torch_gmres import assert_same, replay_golden
from .test_torch_twosided import BACKENDS, check_variant, golden_keys, problem

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("key", golden_keys("cgne", "cgnr"))
def test_golden(key, backend):
    replay_golden(key, getattr(kt, key.split("/")[0]), backend)


# cg on the normal equations takes cg's keywords: M and Ml act on A A^H (or
# A^H A); the weighted inner product would need the adjoint in that inner
# product, so the sweep's uniform weights stand in
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "variant", ["plain", "precond", "blocked", "complex", "inner", "unconverged"])
@pytest.mark.parametrize("name", ["cgne", "cgnr"])
def test_matches_reference(name, variant, backend):
    check_variant(name, variant, "nonsym", ("M",), backend, uniform_inner=True)


@pytest.mark.parametrize("name", ["cgne", "cgnr"])
def test_normal_equations_take_a_sparse_matrix(name):
    A, b, _ = problem("nonsym")
    sp = scipy.sparse.csr_matrix(A)
    x, info = getattr(kt, name)(sp, b, tol=1e-10, backend="while_loop")
    _, info_j = getattr(krylov_tpu, name)(sp, b, tol=1e-10)
    assert info.success
    assert_same(info, info_j, rtol=1e-9)


# --- lsqr: the reference's own problems --------------------------------------


def _lsqr_case(name):
    """``(A, b, kwargs, x_true or None)`` of one of the reference's lsqr
    tests, from its generator and in its order."""
    rng = np.random.default_rng(7)
    n = 60
    A = np.diag(np.linspace(1.0, 4.0, n)) + 0.1 * rng.standard_normal((n, n))
    x_true = rng.standard_normal(n)
    if name == "square":
        return A, A @ x_true, dict(tol=1e-12, maxiter=300), x_true
    A = rng.standard_normal((120, 40))
    b = rng.standard_normal(120)
    if name == "overdetermined":
        return A, b, dict(tol=1e-10, maxiter=400), np.linalg.lstsq(A, b, rcond=None)[0]
    A = rng.standard_normal((30, 90))
    b = rng.standard_normal(30)
    if name == "underdetermined":
        return A, b, dict(tol=1e-12, maxiter=400), np.linalg.lstsq(A, b, rcond=None)[0]
    A = rng.standard_normal((80, 50))
    b = rng.standard_normal(80)
    if name == "damped":
        aug_A = np.vstack([A, 0.7 * np.eye(50)])
        aug_b = np.concatenate([b, np.zeros(50)])
        return (A, b, dict(damp=0.7, tol=1e-12, maxiter=600),
                np.linalg.lstsq(aug_A, aug_b, rcond=None)[0])
    A = scipy.sparse.diags([-1.0, 2.4, -0.8], [-1, 0, 1], shape=(340, 300), format="csr")
    b = rng.standard_normal(340)
    if name == "sparse":
        return A, b, dict(tol=1e-10, maxiter=800), np.linalg.lstsq(
            A.toarray(), b, rcond=None)[0]
    A = rng.standard_normal((90, 45))
    B = rng.standard_normal((90, 3))
    if name == "blocked":
        return A, B, dict(tol=1e-10, maxiter=400), np.linalg.lstsq(A, B, rcond=None)[0]
    A = rng.standard_normal((50, 50)) + 1j * rng.standard_normal((50, 50)) + 4.0 * np.eye(50)
    x_true = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    if name == "complex":
        return A, A @ x_true, dict(tol=1e-12, maxiter=400), x_true
    A = rng.standard_normal((60, 30))
    b = rng.standard_normal(60)
    if name == "unconverged":
        return A, b, dict(tol=1e-14, atol=0.0, maxiter=2), None
    raise KeyError(name)


LSQR_CASES = ["square", "overdetermined", "underdetermined", "damped", "sparse",
              "blocked", "complex", "unconverged"]


@functools.cache
def _lsqr_reference(name):
    A, b, kw, _ = _lsqr_case(name)
    return krylov_tpu.lsqr(A, b, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", LSQR_CASES)
def test_lsqr_reference_problems(name, backend):
    """The reference's own problems: the solution against a direct solve,
    as its tests hold it, and the history against the reference package.
    These random rectangular systems lose the bidiagonalization's
    orthogonality, which amplifies rounding differences between the two
    packages step by step: the first ten entries agree to rtol 1e-9, the
    step counts to within two."""
    A, b, kw, want = _lsqr_case(name)
    sol, info = kt.lsqr(A, b, backend=backend, **kw)
    sol_j, info_j = _lsqr_reference(name)
    assert info.success == bool(info_j.success)
    assert abs(info.numsteps - int(info_j.numsteps)) <= 2
    np.testing.assert_allclose(info.resnorms[:10], np.asarray(info_j.resnorms)[:10],
                               rtol=1e-9)
    assert info.resnorms.shape == (info.numsteps + 1,) + b.shape[1:]
    if name == "unconverged":
        assert sol is None and sol_j is None and info.xk is not None
        return
    assert info.success
    np.testing.assert_allclose(sol.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", ["plain", "blocked", "complex", "inner", "unconverged"])
def test_lsqr_matches_reference(variant, backend):
    """On the sweep's well-conditioned systems the whole solve agrees:
    numsteps, callback count, history (rtol 1e-9), solution."""
    check_variant("lsqr", variant, "nonsym", (), backend, uniform_inner=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lsqr_callback_and_warm_start(backend):
    n = 40
    A = np.diag(np.linspace(1.0, 3.0, n))
    b = np.ones(n)
    counts = []
    sol, info = kt.lsqr(A, b, tol=1e-10, maxiter=200, backend=backend,
                        callback=lambda x, r: counts.append(float(torch.linalg.norm(r))))
    assert info.success and len(counts) == info.numsteps + 1
    # the callback's residual r = phibar * u tracks the true residual
    r_true = np.linalg.norm(b - A @ sol.numpy())
    assert counts[-1] == pytest.approx(max(r_true, 1e-15), rel=1e-6, abs=1e-9)
    # a warm start from half the solution continues to the same solution
    sol2, info2 = kt.lsqr(A, b, x0=sol.numpy() * 0.5, tol=1e-10, maxiter=200,
                          backend=backend)
    assert info2.success
    np.testing.assert_allclose(sol2.numpy(), sol.numpy(), atol=1e-8)


def test_lsqr_zero_rhs_and_shape_check():
    sol, info = kt.lsqr(np.eye(20), np.zeros(20))
    assert info.success
    np.testing.assert_allclose(sol.numpy(), 0.0)
    with pytest.raises(ValueError, match="does not match"):
        kt.lsqr(np.eye(20), np.zeros(19))
