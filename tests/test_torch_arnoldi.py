"""krylov_tpu_torch's Givens rotations, Householder reflections and Arnoldi
processes, held to krylov_tpu on the CPU.

The Arnoldi processes are checked with the reference's own Drkosova-
Greenbaum-Rozloznik-Strakos bounds (``tests/test_arnoldi.py``'s
``assert_arnoldi``) over the same matrices, start vectors, step counts,
preconditioners and inner products, and their Hessenberg columns and bases
against the reference package's (float64 and complex128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.givens import apply_givens as j_apply_givens
from krylov_tpu.givens import lartg as j_lartg
from krylov_tpu_torch import arnoldi as ta
from krylov_tpu_torch.givens import apply_givens, givens, lartg
from krylov_tpu_torch.householder import Householder

from .helpers import (
    get_matrix_comp_nonsymm,
    get_matrix_herm_indef,
    get_matrix_hpd,
    get_matrix_nonsymm,
    get_matrix_spd,
    get_matrix_symm_indef,
)
from .test_arnoldi import _B, assert_arnoldi

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

_FACTORS = [0.0, 1.0, 1.0j, 1.0 + 1.0j, 1e8, 1.0e-8]
_BT = torch.from_numpy(_B)

ALL = [get_matrix_spd(), get_matrix_hpd(), get_matrix_symm_indef(),
       get_matrix_herm_indef(), get_matrix_nonsymm(), get_matrix_comp_nonsymm()]
HERMITIAN = ALL[:4]


def _unit_vec(n):
    x = np.zeros(n)
    x[0] = 1.0
    return x


def _np_inner(i):
    return [lambda x, y: x.T.conj().dot(y), lambda x, y: x.T.conj().dot(_B.dot(y))][i]


def _torch_inner(i):
    if i == 0:
        return lambda x, y: torch.sum(x.conj() * y, dim=0)
    return lambda x, y: torch.sum(x.conj() * (_BT.to(y.dtype) @ y), dim=0)


# ---------------------------------------------------------------------------
# Givens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a", _FACTORS)
@pytest.mark.parametrize("b", _FACTORS)
def test_givens_matches_reference(a, b):
    x = np.array([a, b])
    G, r = givens(torch.from_numpy(x))
    Gj, rj = krylov_tpu.givens(jnp.asarray(x))
    np.testing.assert_allclose(G.numpy(), np.asarray(Gj), rtol=1e-15, atol=1e-300)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-15, atol=1e-300)
    G = G.numpy()
    assert np.allclose(G @ G.T.conj(), np.eye(2), atol=1e-14)
    y = G @ x
    ref_norm = np.linalg.norm(x, 2)
    assert abs(y[1]) <= 1e-14 * (1 + ref_norm)
    assert abs(abs(r.numpy()) - ref_norm) <= 1e-8 * (1 + ref_norm)


def test_lartg_lapack_edge_cases():
    for f, g in ((3.0, 0.0), (0.0, 2.0), (-3.0, 1.0), (0.0, 0.0), (0.0, 2.0j)):
        got = lartg(torch.from_numpy(np.asarray(f)), torch.from_numpy(np.asarray(g)))
        want = j_lartg(jnp.asarray(f), jnp.asarray(g))
        for u, v in zip(got, want):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-15)
    c, s, r = lartg(torch.tensor(0.0, dtype=torch.float64), torch.tensor(2.0,
                                                                          dtype=torch.float64))
    assert float(c) == 0.0 and float(s) == 1.0 and float(r) == 2.0
    assert float(lartg(torch.tensor(-3.0), torch.tensor(1.0))[0]) > 0.0


@pytest.mark.parametrize("shape_tail", [(), (1,), (3,)])
def test_givens_batched(shape_tail):
    X = np.random.default_rng(0).normal(size=(2,) + shape_tail)
    G, R = givens(torch.from_numpy(X))
    assert tuple(G.shape) == (2, 2) + shape_tail and tuple(R.shape) == shape_tail
    Y = apply_givens(G, torch.from_numpy(X)).numpy()
    Gj, _ = krylov_tpu.givens(jnp.asarray(X))
    np.testing.assert_allclose(Y, np.asarray(j_apply_givens(Gj, jnp.asarray(X))),
                               rtol=1e-14, atol=1e-15)
    assert np.allclose(Y[1], 0.0, atol=1e-14) and np.allclose(Y[0], R.numpy(), atol=1e-14)


# ---------------------------------------------------------------------------
# Householder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a", _FACTORS)
@pytest.mark.parametrize("length", [10, 1])
def test_householder_matches_reference(a, length):
    rng = np.random.default_rng(0)
    x = a * (rng.normal(size=length) + 1j * rng.normal(size=length))
    H = Householder(torch.from_numpy(x))
    Hj = krylov_tpu.Householder(jnp.asarray(x))
    for name in ("v", "alpha", "beta", "xnorm"):
        np.testing.assert_allclose(np.asarray(getattr(H, name)), np.asarray(getattr(Hj, name)),
                                   rtol=1e-14, atol=1e-300)
    y = (H @ torch.from_numpy(x)).numpy()
    xnorm = np.linalg.norm(x, 2)
    assert abs(abs(y[0]) - xnorm) <= 1e-14 * (1 + xnorm)
    assert np.linalg.norm(y[1:], 2) <= 1e-14 * (1 + xnorm)
    M = H.matrix().numpy()
    assert np.allclose(M @ M.T.conj(), np.eye(length), atol=1e-14)


def test_householder_edge_cases():
    H = Householder(torch.tensor([2.0, 0.0, 0.0], dtype=torch.float64))
    assert float(H.beta) == 0.0
    np.testing.assert_allclose((H @ torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
                               .numpy(), [1.0, 2.0, 3.0])
    x = torch.tensor([[3.0], [4.0]], dtype=torch.float64)
    y = Householder(x) @ x
    assert tuple(y.shape) == (2, 1) and abs(abs(float(y[0, 0])) - 5.0) < 1e-14
    with pytest.raises(ValueError, match="quasi-1D"):
        Householder(torch.ones((3, 2)))


@pytest.mark.parametrize("pivot", [0, 3, 9])
def test_padded_reflector_is_the_suffix_householder(pivot):
    w = torch.from_numpy(np.random.default_rng(pivot).standard_normal((10, 2)))
    u, beta, alpha, xnorm = ta.padded_reflector_at(w, pivot)
    assert torch.all(u[:pivot] == 0)
    for col in range(2):
        H = Householder(w[pivot:, col])
        np.testing.assert_allclose(u[pivot:, col].numpy(), H.v.numpy(), rtol=1e-14)
        for got, want in ((beta, H.beta), (alpha, H.alpha), (xnorm, H.xnorm)):
            np.testing.assert_allclose(got[col].numpy(), want.numpy(), rtol=1e-14)


# ---------------------------------------------------------------------------
# Arnoldi: the reference's bounds
# ---------------------------------------------------------------------------


def _run_gram_schmidt(cls, A, v, maxiter, M, inner_i, **kw):
    arnoldi = cls(A, torch.from_numpy(v), M=M, inner=_torch_inner(inner_i), **kw)
    cols = []
    while arnoldi.iter < maxiter and not arnoldi.is_invariant:
        _, h = next(arnoldi)
        cols.append(h.numpy())
    H = np.zeros((arnoldi.iter + 1, arnoldi.iter), dtype=np.asarray(cols[0]).dtype)
    for k, val in enumerate(cols):
        H[: k + 2, k] = val
    if arnoldi.is_invariant:
        H = H[:-1]
    return arnoldi, H


@pytest.mark.parametrize("A", ALL)
@pytest.mark.parametrize("v", [np.ones(10), _unit_vec(10)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("M", [None, _B])
@pytest.mark.parametrize("inner", [0, 1])
@pytest.mark.parametrize("ortho", ["mgs", "cgs"])
def test_arnoldi_gram_schmidt_bounds(A, v, maxiter, M, inner, ortho):
    cls = ta.ArnoldiMGS if ortho == "mgs" else ta.ArnoldiCGS
    arnoldi, H = _run_gram_schmidt(cls, A, v, maxiter, M, inner)
    V = [x.numpy() for x in arnoldi.V]
    P = [x.numpy() for x in arnoldi.P]
    assert_arnoldi(A, v, V, H, P, maxiter, ortho, M, _np_inner(inner),
                   An=np.linalg.norm(A, 2))


@pytest.mark.parametrize("A", ALL[::2] + [get_matrix_nonsymm()])
@pytest.mark.parametrize("v", [np.ones(10), _unit_vec(10)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
def test_arnoldi_householder_bounds(A, v, maxiter):
    arnoldi = ta.ArnoldiHouseholder(A, torch.from_numpy(v))
    cols = []
    while arnoldi.iter < maxiter and not arnoldi.is_invariant:
        _, h = next(arnoldi)
        cols.append(h.numpy())
    H = np.zeros((arnoldi.iter + 1, arnoldi.iter), dtype=np.result_type(A, v))
    for k, val in enumerate(cols):
        H[: len(val), k] = val
    if arnoldi.is_invariant:
        H = H[:-1]
    assert_arnoldi(A, v, [x.numpy() for x in arnoldi.V], H, None, maxiter, "house", None,
                   _np_inner(0), An=np.linalg.norm(A, 2))


@pytest.mark.parametrize("A", HERMITIAN)
@pytest.mark.parametrize("v", [np.ones(10), _unit_vec(10)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("M", [None, _B])
@pytest.mark.parametrize("inner", [0, 1])
def test_arnoldi_lanczos_bounds(A, v, maxiter, M, inner):
    arnoldi = ta.ArnoldiLanczos(A, torch.from_numpy(v.copy()), M=M, inner=_torch_inner(inner))
    V, P = [arnoldi.v.numpy()], [arnoldi.p.numpy()]
    tri = []
    for _ in range(maxiter):
        if arnoldi.is_invariant:
            break
        vv, h, p = next(arnoldi)
        if vv is not None:
            V.append(vv.numpy())
        if p is not None:
            P.append(p.numpy())
        tri.append(h.numpy().copy())
    k = len(tri)
    H = np.zeros((k + 1, k), dtype=np.result_type(A, v))
    for i, vals in enumerate(tri):
        if i == 0:
            H[:2, i] = vals[1:]
        else:
            H[i - 1: i + 2, i] = vals
    if arnoldi.is_invariant:
        H = H[:k]
    assert_arnoldi(A, v, V, H, P, maxiter, "lanczos", M, _np_inner(inner),
                   An=np.linalg.norm(A, 2))


# ---------------------------------------------------------------------------
# Arnoldi: the reference's columns and bases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("process,A", [(p, A) for p in ("mgs", "cgs", "householder")
                                       for A in ALL] + [("lanczos", A) for A in HERMITIAN])
def test_arnoldi_matches_reference(process, A):
    """Five steps against the reference's; 1e-10 absorbs the rounding that
    the indefinite Hermitian matrix's Lanczos recurrence amplifies."""
    v = np.ones(10)
    make = {
        "mgs": (lambda: ta.ArnoldiMGS(A, torch.from_numpy(v), M=_B),
                lambda: krylov_tpu.ArnoldiMGS(A, v, M=_B)),
        "cgs": (lambda: ta.ArnoldiCGS(A, torch.from_numpy(v)),
                lambda: krylov_tpu.ArnoldiCGS(A, v)),
        "householder": (lambda: ta.ArnoldiHouseholder(A, torch.from_numpy(v)),
                        lambda: krylov_tpu.ArnoldiHouseholder(A, v)),
        "lanczos": (lambda: ta.ArnoldiLanczos(A, torch.from_numpy(v)),
                    lambda: krylov_tpu.ArnoldiLanczos(A, v)),
    }[process]
    mine, theirs = make[0](), make[1]()
    for _ in range(5):
        got, want = next(mine), next(theirs)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


def test_arnoldi_res_diagnostic_and_breakdown():
    A = get_matrix_spd()
    arnoldi = ta.ArnoldiMGS(A, torch.ones(10, dtype=torch.float64))
    hs = [next(arnoldi)[1].numpy() for _ in range(5)]
    H = np.zeros((6, 5))
    for k, val in enumerate(hs):
        H[: k + 2, k] = val.real
    V = torch.stack(arnoldi.V, dim=1)
    assert float(torch.linalg.norm(ta.arnoldi_res(A, V, H))) <= 1e-13
    # e_1 spans an invariant subspace of a diagonal matrix
    inv = ta.ArnoldiMGS(A, torch.from_numpy(_unit_vec(10)))
    next(inv)
    assert inv.is_invariant
    with pytest.raises(kt.ArgumentError, match="invariant"):
        next(inv)
