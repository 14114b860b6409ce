"""krylov_tpu_torch.utils and ChebyshevPreconditioner held to krylov_tpu on
the CPU.

The cases of ``tests/test_utils.py`` and
``tests/test_aux_subsystems.py::test_chebyshev_polynomial_preconditioner``
run through both packages on the same inputs, made from a seed with numpy
(float64), and the port's results are held to the same contracts and to
the reference's values: ``qr`` within 1e-12 (the same modified
Gram-Schmidt in the same order; the default inner defers to each
framework's Householder QR, compared up to column signs), ``angles``
within 1e-9 of the reference and of the prescribed angles as
``test_utils.py`` bounds them, ``hegedus`` within rtol 1e-12,
``estimate_spectrum`` within rtol 1e-10 (both packages draw the start
vector from ``numpy.random.default_rng(seed)``, so the Lanczos runs are the
same), the host-side polynomial utilities exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import stencil as jstencil
from krylov_tpu_torch.ops import stencil as tstencil

from .test_torch_gmres import assert_same
from .test_utils import _plane_pair, _qr_inputs, _rng

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

_B = np.diag(np.linspace(1.0, 5.0, 10))


def inners(xp):
    """``tests/helpers.get_inners`` for numpy, jax or torch operands: the
    Euclidean inner and one weighted by ``diag(linspace(1, 5, 10))``."""
    if xp is torch:
        B = torch.from_numpy(_B)
        return [lambda x, y: x.mH @ y, lambda x, y: x.mH @ (B.to(y.dtype) @ y)]
    return [lambda x, y: np.dot(x.T.conj(), y), lambda x, y: np.dot(x.T.conj(), np.dot(_B, y))]


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# qr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["well", "hilbert", "complex"])
@pytest.mark.parametrize("inner_idx", [0, 1])
@pytest.mark.parametrize("reorthos", [0, 1, 2])
def test_qr_contract(case, inner_idx, reorthos):
    X = _qr_inputs()[case]
    n, k = X.shape
    Q, R = kt.utils.qr(torch.from_numpy(X), inner=inners(torch)[inner_idx], reorthos=reorthos)
    Q, R = Q.numpy(), R.numpy()
    assert Q.shape == (n, k) and R.shape == (k, k)
    assert np.linalg.norm(np.tril(R, -1)) == 0
    smax = scipy.linalg.svd(X, compute_uv=False).max()
    assert np.linalg.norm(Q @ R - X, 2) <= 1e-13 * smax
    inner = inners(np)[inner_idx]
    loss = np.linalg.norm(inner(Q, Q) - np.eye(k), 2)
    assert loss <= (1e-8 if reorthos == 0 else 1e-14)
    Qj, Rj = krylov_tpu.utils.qr(X, inner=inner, reorthos=reorthos)
    # ill-conditioned columns amplify the last-bit differences of the two
    # frameworks' dot products: R is held relative to its largest entry
    np.testing.assert_allclose(R, np.asarray(Rj), atol=1e-12 * np.abs(R).max())
    if case != "hilbert":
        np.testing.assert_allclose(Q, np.asarray(Qj), atol=1e-12)


def test_qr_default_inner_and_empty():
    X = _qr_inputs()["hilbert"]
    Q, R = kt.utils.qr(X)  # an ndarray goes to the default device
    assert isinstance(Q, torch.Tensor)
    assert np.linalg.norm(Q.numpy() @ R.numpy() - X, 2) <= 1e-13
    Qj, Rj = krylov_tpu.utils.qr(X)
    signs = np.sign(np.diag(R.numpy())) * np.sign(np.diag(np.asarray(Rj)))
    np.testing.assert_allclose(R.numpy() * signs[:, None], np.asarray(Rj), atol=1e-12)
    Q0, R0 = kt.utils.qr(np.zeros((7, 0)))
    assert tuple(Q0.shape) == (7, 0) and tuple(R0.shape) == (0, 0)


def test_qr_zero_column_stays_unnormalized():
    X = np.c_[np.ones(6), np.ones(6), np.arange(6.0)]
    Q, R = kt.utils.qr(torch.from_numpy(X), inner=inners(torch)[0])
    Qj, Rj = krylov_tpu.utils.qr(X, inner=inners(np)[0])
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-14)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), atol=1e-14)
    assert abs(R[1, 1]) < 1e-15


# ---------------------------------------------------------------------------
# angles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "thetas",
    [[0.3, 0.7, 1.2], [0.0, 0.5], [1e-8, 1e-6, 0.2], [np.pi / 2 - 1e-3, np.pi / 2]],
)
def test_angles_prescribed(thetas):
    F, G = _plane_pair(thetas)
    got = np.sort(kt.utils.angles(torch.from_numpy(F), torch.from_numpy(G)).numpy())
    want = np.sort(np.asarray(thetas, float))
    assert np.all(np.abs(got - want) <= 1e-10 + 1e-7 * want)
    ref = np.sort(np.asarray(krylov_tpu.utils.angles(F, G)))
    assert np.all(np.abs(got - ref) <= 1e-9 + 1e-7 * ref)


def test_angles_small_angle_relative_accuracy():
    t = 1e-8
    F, G = _plane_pair([t])
    got = float(kt.utils.angles(F, G)[0])
    assert abs(got - t) <= 1e-4 * t


def test_angles_shape_symmetry_and_padding():
    rng = _rng(5)
    F = torch.from_numpy(rng.standard_normal((10, 5)))
    G = torch.from_numpy(rng.standard_normal((10, 2)))
    th = kt.utils.angles(F, G).numpy()
    assert th.shape == (5,)
    assert np.all(np.diff(th) >= -1e-15)
    assert np.all((th >= 0) & (th <= np.pi / 2 + 1e-15))
    assert np.all(np.abs(th[-3:] - np.pi / 2) <= 1e-15)
    np.testing.assert_allclose(th, kt.utils.angles(G, F).numpy(), atol=1e-13)
    assert np.linalg.norm(kt.utils.angles(F, F).numpy()) <= 1e-7
    np.testing.assert_allclose(
        th, np.asarray(krylov_tpu.utils.angles(F.numpy(), G.numpy())), atol=1e-12)
    empty = kt.utils.angles(F, torch.zeros((10, 0), dtype=torch.float64))
    np.testing.assert_array_equal(empty.numpy(), np.full(5, np.pi / 2))


@pytest.mark.parametrize("inner_idx", [0, 1])
@pytest.mark.parametrize("dims", [(1, 1), (4, 4), (4, 2), (2, 4), (4, 4j)])
def test_angles_vectors_pairing(inner_idx, dims):
    rng = _rng(7)
    kf, kg = dims
    complex_ = isinstance(kg, complex)
    if complex_:
        kg = int(kg.imag)
    n = 10

    def draw(k):
        X = rng.standard_normal((n, k))
        return X + 1j * rng.standard_normal((n, k)) if complex_ else X

    F, G = draw(kf), draw(kg)
    inner_t, inner = inners(torch)[inner_idx], inners(np)[inner_idx]
    th, U, V = kt.utils.angles(torch.from_numpy(F), torch.from_numpy(G), inner=inner_t,
                               compute_vectors=True)
    th, U, V = th.numpy(), U.numpy(), V.numpy()
    np.testing.assert_allclose(
        kt.utils.angles(torch.from_numpy(F), torch.from_numpy(G), inner=inner_t).numpy(),
        th, atol=1e-13)
    assert U.shape == F.shape and V.shape == G.shape
    want = np.zeros((kf, kg))
    m = min(kf, kg)
    want[:m, :m] = np.diag(np.cos(th))[:m, :m]
    assert np.linalg.norm(inner(U, V) - want) <= 1e-12
    assert np.linalg.norm(inner(U, U) - np.eye(kf)) <= 1e-12
    assert np.linalg.norm(inner(V, V) - np.eye(kg)) <= 1e-12
    np.testing.assert_allclose(th, np.asarray(krylov_tpu.utils.angles(F, G, inner=inner)),
                               atol=1e-12)


# ---------------------------------------------------------------------------
# hegedus
# ---------------------------------------------------------------------------


def _hegedus_norm(A, b, z, M, Ml, inner):
    r = b - A @ z
    Mlr = r if Ml is None else Ml @ r
    MMlr = Mlr if M is None else M @ Mlr
    return float(np.sqrt(np.abs(inner(Mlr, MMlr))).reshape(()))


@pytest.mark.parametrize("prec", ["none", "M", "Ml", "both"])
@pytest.mark.parametrize("inner_idx", [0, 1])
@pytest.mark.parametrize("x0_kind", ["zero", "scaled_sol", "random"])
def test_hegedus_minimizes_over_gamma_line(prec, inner_idx, x0_kind):
    rng = _rng(11)
    n = 10
    A = np.diag(np.arange(2.0, 2.0 + n)) + 0.3 * rng.standard_normal((n, n))
    x_true = np.ones((n, 1))
    b = A @ x_true
    x0 = {"zero": np.zeros((n, 1)), "scaled_sol": 7.3 * x_true,
          "random": rng.standard_normal((n, 1))}[x0_kind]
    d = np.diag(1.0 + rng.random(n))
    M = d if prec in ("M", "both") else None
    Ml = d if prec in ("Ml", "both") else None
    inner = inners(np)[inner_idx]

    def t(a):
        return None if a is None else torch.from_numpy(a)

    x0_new = kt.utils.hegedus(t(A), t(b), t(x0), t(M), t(Ml), inners(torch)[inner_idx]).numpy()
    got = _hegedus_norm(A, b, x0_new, M, Ml, inner)
    for gamma in np.linspace(-2.0, 2.0, 41):
        assert got <= _hegedus_norm(A, b, gamma * x0, M, Ml, inner) + 1e-12
    ref = np.asarray(krylov_tpu.utils.hegedus(A, b, x0, M, Ml, inner))
    np.testing.assert_allclose(x0_new, ref, rtol=1e-12, atol=1e-14)


def test_hegedus_zero_direction_returns_zero_guess():
    out = kt.utils.hegedus(kt.as_operator(np.eye(4)), np.ones(4), np.zeros(4))
    np.testing.assert_array_equal(out.numpy(), np.zeros(4))


# ---------------------------------------------------------------------------
# strakos / gap / NormalizedRootsPolynomial
# ---------------------------------------------------------------------------


def test_strakos_matrix():
    S = kt.utils.strakos(5)
    assert S.dtype == torch.float64 and tuple(S.shape) == (5, 5)
    d = np.diag(S.numpy())
    assert abs(d[0] - 0.1) < 1e-14
    assert np.all(np.diff(d) > 0)
    assert abs(d[-1] - 100.0) < 1e-12
    np.testing.assert_array_equal(S.numpy(), np.asarray(krylov_tpu.utils.strakos(5)))
    np.testing.assert_array_equal(kt.utils.strakos(7, 0.5, 10, 0.8).numpy(),
                                  np.asarray(krylov_tpu.utils.strakos(7, 0.5, 10, 0.8)))


def test_gap_modes():
    gap = kt.utils.gap
    assert abs(gap([1, 2], [-4, 3]) - 1) < 1e-14
    assert abs(gap(5, -5) - 10) < 1e-14
    assert abs(gap([-5, 5], -5) - 0) < 1e-14
    assert abs(gap(5, -5, mode="interval") - 10) < 1e-14
    assert abs(gap(5, [-5, 6], mode="interval") - 1) < 1e-14
    assert abs(gap(-5, [-5, 6], mode="interval") - 0) < 1e-14
    assert gap([-5, 5], [0], mode="interval") is None
    assert gap(torch.tensor([1.0, 2.0]), torch.tensor([-4.0, 3.0])) == 1.0
    with pytest.raises(kt.ArgumentError, match="complex spectra"):
        gap([1j], [2])
    with pytest.raises(kt.ArgumentError, match="unknown mode"):
        gap([1], [2], mode="hull")
    rng = _rng(2)
    for mode in ("individual", "interval"):
        lam, sig = rng.standard_normal(6), 3 + rng.random(4)
        assert gap(lam, sig, mode=mode) == krylov_tpu.utils.gap(lam, sig, mode=mode)


@pytest.mark.parametrize("roots", [[1, 2], [1, 1j], [1, 2, 1e8], [1, 2, 1e8, 1e8 + 1e-3]])
def test_normalized_roots_polynomial(roots):
    p = kt.utils.NormalizedRootsPolynomial(roots)
    np.testing.assert_array_equal(p(np.asarray(roots)), np.zeros(len(roots)))
    assert p(0) == 1
    ref = krylov_tpu.utils.NormalizedRootsPolynomial(roots)
    pts = np.linspace(0.5, 2.5, 17)
    np.testing.assert_array_equal(p(pts), ref(pts))
    np.testing.assert_array_equal(p(torch.from_numpy(pts)), ref(pts))
    if np.isrealobj(roots):
        interval = np.linspace(roots[0], roots[1], 100)
        cand = [roots[0], roots[1]] + [
            c for c in p.minmax_candidates() if roots[0] <= c <= roots[1]]
        np.testing.assert_almost_equal(
            np.max(np.abs(p(interval))), np.max(np.abs(p(np.asarray(cand)))), decimal=4)
    with pytest.raises(kt.ArgumentError):
        kt.utils.NormalizedRootsPolynomial(np.ones((2, 2)))
    with pytest.raises(kt.ArgumentError):
        p(np.ones((2, 2)))


def test_normalized_roots_polynomial_overflow_safety():
    roots = np.linspace(0.01, 2.0, 5000)
    p = kt.utils.NormalizedRootsPolynomial(roots)
    factors = 1.0 - 1.0 / roots
    desc = np.sort(np.abs(factors))[::-1]
    assert np.cumprod(desc[:300]).max() == np.inf
    val = p(np.asarray([1.0]))[0]
    assert np.isfinite(val)
    assert val == krylov_tpu.utils.NormalizedRootsPolynomial(roots)(np.asarray([1.0]))[0]


# ---------------------------------------------------------------------------
# estimate_spectrum and ChebyshevPreconditioner
# ---------------------------------------------------------------------------


def test_estimate_spectrum_bounds_chebyshev():
    Aj, At = jstencil.poisson_2d(16, 16), tstencil.poisson_2d(16, 16)
    lo, hi = kt.utils.estimate_spectrum(At, iters=40)
    assert 0 < lo < hi <= 8.5
    np.testing.assert_allclose((lo, hi), krylov_tpu.utils.estimate_spectrum(Aj, iters=40),
                               rtol=1e-10)
    b = _rng(3).standard_normal(256)
    sol, info = kt.chebyshev(At, b, eigenvalue_estimates=(lo, hi), tol=1e-6, maxiter=3000)
    assert info.success


def test_estimate_spectrum_arguments():
    A = np.diag(np.linspace(1.0, 9.0, 30))
    for kw in (dict(), dict(seed=4, iters=12), dict(safety=1.2),
               dict(M=np.diag(1.0 / np.linspace(1.0, 2.0, 30)))):
        got = kt.utils.estimate_spectrum(kt.as_operator(A), **kw)
        want = krylov_tpu.utils.estimate_spectrum(krylov_tpu.as_operator(A), **kw)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    lo, hi = kt.utils.estimate_spectrum(kt.as_operator(A))
    assert lo <= 1.0 and hi >= 9.0  # 30 steps on 30 rows: the exact ends, widened

    class Bare:
        def __matmul__(self, x):
            return 2.0 * x

    with pytest.raises(kt.ArgumentError, match="pass n="):
        kt.utils.estimate_spectrum(Bare())
    lo, hi = kt.utils.estimate_spectrum(Bare(), n=5)
    np.testing.assert_allclose((lo, hi), (2 / 1.05, 2 * 1.05), rtol=1e-12)
    # a float32 operator gets a float32 start vector
    A32 = tstencil.poisson_2d(8, 8, dtype=np.float32)
    lo, hi = kt.utils.estimate_spectrum(A32)
    assert 0 < lo < hi <= 8.5


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_chebyshev_polynomial_preconditioner(backend):
    Aj, At = jstencil.poisson_2d(32, 32), tstencil.poisson_2d(32, 32)
    interval = kt.utils.estimate_spectrum(At, iters=40)
    M = kt.ChebyshevPreconditioner(At, interval, degree=6)
    assert M.shape == (1024, 1024) and M.dtype == torch.float64 and M.device.type == "cpu"
    b = np.random.default_rng(0).standard_normal(1024)
    sol_p, info_p = kt.cg(At, b, M=M, tol=1e-9, maxiter=400, backend=backend)
    sol_n, info_n = kt.cg(At, b, tol=1e-9, maxiter=400, backend=backend)
    assert info_p.success
    assert info_p.numsteps * 2 < info_n.numsteps
    r = np.linalg.norm(b - (At @ sol_p).numpy())
    assert r <= 1e-7 * (1 + np.linalg.norm(b))
    Mj = krylov_tpu.ChebyshevPreconditioner(Aj, interval, degree=6)
    ref = krylov_tpu.cg(Aj, jnp.asarray(b), M=Mj, tol=1e-9, maxiter=400,
                        backend="while_loop")[1]
    assert_same(info_p, ref, rtol=1e-8)
    sol_m, info_m = kt.minres(At, b, M=M, tol=1e-8, maxiter=400, backend=backend)
    assert info_m.success
    # one application equals the reference's, and is a polynomial in A: self-adjoint
    r0 = torch.from_numpy(b)
    np.testing.assert_allclose((M @ r0).numpy(), np.asarray(Mj @ jnp.asarray(b)), rtol=1e-12)
    assert torch.equal(M.rmatvec(r0), M @ r0) and torch.equal(M.matvec(r0), M @ r0)


def test_from_reference_chebyshev_preconditioner():
    Aj = jstencil.poisson_2d(12, 10)
    Mj = krylov_tpu.ChebyshevPreconditioner(Aj, (0.05, 7.9), degree=5)
    M = kt.convert.from_reference(Mj)
    assert isinstance(M, kt.ChebyshevPreconditioner)
    assert (M.lmin, M.lmax, M.degree) == (0.05, 7.9, 5)
    assert isinstance(M.A, tstencil.GridStencilOperator)
    r = np.random.default_rng(1).standard_normal((120, 2))
    np.testing.assert_allclose((M @ torch.from_numpy(r)).numpy(),
                               np.asarray(Mj @ jnp.asarray(r)), rtol=1e-12)
    # over a dense matrix, and the smoother rebuilt from the converted operator
    Ad = np.asarray(Aj.todense())
    M2 = kt.convert.from_reference(krylov_tpu.ChebyshevPreconditioner(Ad, (0.05, 7.9), 3))
    assert isinstance(M2.A, kt.MatrixOperator) and M2.degree == 3
    S = kt.SSORSmoother(kt.convert.from_reference(Aj), omega=1.1)
    Sj = krylov_tpu.SSORSmoother(Aj, omega=1.1)
    np.testing.assert_allclose((S @ torch.from_numpy(r)).numpy(),
                               np.asarray(Sj @ jnp.asarray(r)), rtol=1e-10)
