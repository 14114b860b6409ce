"""krylov_tpu_torch.gmres held to krylov_tpu.gmres on the CPU.

Every ``gmres*`` entry of ``tests/fixtures/golden.json`` is replayed through
the port on both backends within ``test_golden.py``'s bands (float64), and
the orthogonalizations, restarts, preconditioners, blocked right-hand sides
and callbacks are compared with the reference package on the same inputs,
made from a seed with numpy: equal ``numsteps`` and resnorm histories within
rtol 1e-10.
"""

import functools
import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt

from .linear_problems import complex_unsymmetric, real_unsymmetric
from .test_golden import GOLDEN, LOOSE_CASES, _case_setup, _decode

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

GMRES_KEYS = sorted(k for k in GOLDEN if k.startswith("gmres"))


def replay_golden(key, fn, backend, band=None):
    """Replay one golden entry through the port's ``fn`` as test_golden
    replays it through the reference, within ``LOOSE_CASES``'s band for the
    entry unless the caller states another."""
    _, A, b, kwargs = _case_setup(key)
    ref = GOLDEN[key]
    sol, info = fn(A, b, backend=backend, **kwargs)
    assert info.success == ref["success"]
    assert info.numsteps == ref["numsteps"]
    band = LOOSE_CASES.get(key, 1e-11) if band is None else band
    mine, theirs = np.asarray(info.resnorms), np.asarray(ref["resnorms"])
    assert mine.shape == theirs.shape
    band_arr = np.broadcast_to(
        np.reshape(band, np.shape(band) + (1,) * (theirs.ndim - np.ndim(band)))
        if np.ndim(band) else band,
        theirs.shape,
    )
    assert np.all(np.abs(mine - theirs) <= band_arr * (1.0 + theirs)), (mine, theirs)
    xk_ref = _decode(ref["xk"])
    xk = info.xk.numpy()
    scale = 1.0 + np.max(np.abs(xk_ref))
    assert np.all(np.abs(xk - xk_ref) <= max(float(np.max(band)), 1e-7) * scale)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("key", GMRES_KEYS)
def test_golden(key, backend):
    replay_golden(key, kt.gmres, backend)


def assert_same(info_t, info_j, rtol=1e-10):
    assert info_t.success == bool(info_j.success)
    assert info_t.numsteps == int(info_j.numsteps)
    want = np.asarray(info_j.resnorms)
    assert info_t.resnorms.shape == want.shape
    np.testing.assert_allclose(info_t.resnorms, want, rtol=rtol,
                               atol=1e-14 * np.max(np.abs(want[0])))
    np.testing.assert_allclose(info_t.xk.numpy(), np.asarray(info_j.xk),
                               rtol=1e-9, atol=1e-12)


@functools.cache
def _reference(name, arg):
    """The reference's solve for one case (``arg``: the ortho, or the
    restart length), shared by both backends' tests: compiled where the
    case allows, since its eager driver would dominate this file's run
    time."""
    kw = dict(backend="while_loop")
    if name == "precond_complex":
        A, b = complex_unsymmetric()
        return krylov_tpu.gmres(A, b, tol=1e-9, **_complex_preconditioners(A, b))[1]
    if name == "unconverged":
        A, b = real_unsymmetric()
        return krylov_tpu.gmres(A, b, tol=1e-30, atol=0.0, maxiter=3)
    if name == "sparse":
        A, b = real_unsymmetric()
        return krylov_tpu.gmres(scipy.sparse.csr_matrix(np.asarray(A)), b, tol=1e-10)[1]
    if name == "orthos":
        A, b, _ = _nonsym()
        return krylov_tpu.gmres(A, b, ortho=arg, tol=1e-10, maxiter=40, **kw)[1]
    if name == "blocked":
        A, _, B = _nonsym(seed=1)
        return krylov_tpu.gmres(A, B, ortho=arg, tol=1e-9, maxiter=40, **kw)[1]
    A, b, _ = _nonsym(n=60, seed=2)
    return krylov_tpu.gmres(A, b, restart=arg, tol=1e-9, maxiter=200, **kw)[1]


def _nonsym(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 3.0, n)) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    return A, rng.standard_normal(n), rng.standard_normal((n, 3))


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("ortho", ["mgs", "mgs2", "cgs", "cgs1", "householder"])
def test_orthos_match_reference(ortho, backend):
    A, b, _ = _nonsym()
    _, it = kt.gmres(A, b, ortho=ortho, tol=1e-10, maxiter=40, backend=backend)
    ij = _reference("orthos", ortho)
    assert it.success
    assert_same(it, ij)
    assert it.num_operations == ij.num_operations


@pytest.mark.parametrize("ortho,backend", [
    ("mgs", "eager"), ("mgs", "while_loop"), ("cgs", "eager"), ("cgs", "while_loop"),
    ("householder", "while_loop"),  # eager Householder takes one column, as the reference
])
def test_blocked_rhs_matches_reference(ortho, backend):
    A, _, B = _nonsym(seed=1)
    x, it = kt.gmres(A, B, ortho=ortho, tol=1e-9, maxiter=40, backend=backend)
    ij = _reference("blocked", ortho)
    assert tuple(x.shape) == B.shape and it.resnorms.shape == (it.numsteps + 1, 3)
    assert_same(it, ij)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("restart", [5, 12])
def test_restart_matches_reference(restart, backend):
    A, b, _ = _nonsym(n=60, seed=2)
    _, it = kt.gmres(A, b, restart=restart, tol=1e-9, maxiter=200, backend=backend)
    ij = _reference("restart", restart)
    assert it.success
    assert_same(it, ij, rtol=1e-8)


def _complex_preconditioners(A, b):
    return dict(Ml=np.diag(1.0 / np.diag(np.asarray(A))),
                Mr=np.diag(np.linspace(1.0, 2.0, b.shape[0])))


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_preconditioned_complex_matches_reference(backend):
    A, b = complex_unsymmetric()
    _, it = kt.gmres(A, b, tol=1e-9, backend=backend, **_complex_preconditioners(A, b))
    assert_same(it, _reference("precond_complex", None), rtol=1e-9)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_callback_unconverged_and_sparse_input(backend):
    A, b = real_unsymmetric()
    seen = []
    x, info = kt.gmres(A, b, tol=1e-30, atol=0.0, maxiter=3, backend=backend,
                       callback=lambda xk, r: seen.append(float(r)))
    xj, info_j = _reference("unconverged", None)
    assert x is None and xj is None and not info.success
    assert len(seen) == info.numsteps + 1 == 4
    assert_same(info, info_j)
    # a scipy CSR matrix goes through as_operator
    sp = scipy.sparse.csr_matrix(np.asarray(A))
    _, i_sp = kt.gmres(sp, b, tol=1e-10, backend=backend)
    assert_same(i_sp, _reference("sparse", None))


def test_errors_and_warning():
    A, b, _ = _nonsym()
    with pytest.raises(ValueError, match="unknown orthogonalization"):
        kt.gmres(A, b, ortho="qr", backend="while_loop")
    with pytest.raises(ValueError, match="does not support M"):
        kt.gmres(A, b, ortho="householder", M=np.eye(40), backend="while_loop")
    with pytest.raises(ValueError, match="default inner"):
        kt.gmres(A, b, ortho="householder", inner=lambda x, y: (x.conj() * y).sum(0))
    n = 1 << 13
    sp = scipy.sparse.identity(n, format="csr")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, info = kt.gmres(sp, np.ones(n), backend="while_loop")
    assert info.success and any("O(N^2)" in str(m.message) for m in w)
