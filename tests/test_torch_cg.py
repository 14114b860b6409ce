"""krylov_tpu_torch.cg and its driver, held to krylov_tpu.cg on the CPU.

Same problems, same arguments, inputs made from a seed with numpy: equal
``numsteps`` and resnorm histories within rtol 1e-10 (float64).  The last
history entry of a converged solve is the explicit residual, which sits at
the rounding floor; it is compared with an absolute band of 1e-14 * r0
besides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import stencil as js
from krylov_tpu_torch import DiagonalOperator
from krylov_tpu_torch.ops import stencil as ts

from .linear_problems import spd_dense, spd_rhs_0

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

GOLDEN_SUM = 1004.1873775173957


def _golden():
    return np.diag([1.0e-3] + list(range(2, 101))), np.ones(100)


def assert_same_solve(info_t, info_j, rtol=1e-10):
    assert info_t.success == bool(info_j.success)
    assert info_t.numsteps == int(info_j.numsteps)
    want = np.asarray(info_j.resnorms)
    assert info_t.resnorms.shape == want.shape
    np.testing.assert_allclose(
        info_t.resnorms, want, rtol=rtol, atol=1e-14 * np.max(np.abs(want[0]))
    )


def test_golden_matches_reference():
    A, b = _golden()
    x, info = kt.cg(A, b)
    xj, info_j = krylov_tpu.cg(A, b)
    assert info.success
    np.testing.assert_allclose(float(x.abs().sum()), GOLDEN_SUM, rtol=1e-11)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-11)
    assert_same_solve(info, info_j)
    assert info.num_operations == info_j.num_operations


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("b_shape", [(5,), (5, 1), (5, 3)])
def test_zoo_shapes_match_reference(b_shape, backend):
    A, b = spd_dense(b_shape)
    x, info = kt.cg(A, b, tol=1e-7, backend=backend)
    xj, info_j = krylov_tpu.cg(A, b, tol=1e-7)
    assert tuple(x.shape) == b_shape and info.resnorms.shape == (
        (info.numsteps + 1,) + b_shape[1:]
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10)
    assert_same_solve(info, info_j)


@pytest.mark.parametrize("b_shape", [(5,), (5, 3)])
def test_zero_rhs_matches_reference(b_shape):
    A, b = spd_rhs_0(b_shape)
    x, info = kt.cg(A, b)
    xj, info_j = krylov_tpu.cg(A, b)
    assert info.success and info.numsteps == 0
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert_same_solve(info, info_j)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_callback_fires_numsteps_plus_one(backend):
    A, b = _golden()
    seen = []
    _, info = kt.cg(A, b, callback=lambda x, r: seen.append(float(r.norm())),
                    backend=backend)
    assert len(seen) == info.numsteps + 1
    seen_j = []
    _, info_j = krylov_tpu.cg(A, b, callback=lambda x, r: seen_j.append(0))
    assert len(seen_j) == len(seen)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_unconverged_returns_none(backend):
    A, b = _golden()
    x, info = kt.cg(A, b, tol=1e-30, atol=0.0, maxiter=7, backend=backend)
    xj, info_j = krylov_tpu.cg(A, b, tol=1e-30, atol=0.0, maxiter=7)
    assert x is None and xj is None
    assert not info.success and info.numsteps == 7
    assert info.xk is not None and tuple(info.xk.shape) == (100,)
    assert_same_solve(info, info_j)


def test_while_loop_equals_eager():
    """The two backends run the same steps: identical histories and iterates."""
    A, b = _golden()
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(100)
    _, ie = kt.cg(A, b, x0=x0, tol=1e-9, backend="eager")
    _, iw = kt.cg(A, b, x0=x0, tol=1e-9, backend="while_loop")
    assert ie.numsteps == iw.numsteps and ie.success == iw.success
    np.testing.assert_array_equal(ie.resnorms, iw.resnorms)
    assert torch.equal(ie.xk, iw.xk)


def _first_overwrite(recurrence, history, criterion):
    over = np.flatnonzero((recurrence <= criterion) & (history > criterion))
    return int(over[0]) if over.size else None


def test_explicit_recheck_overwrite_persists():
    """A recheck that fails still overwrites the history entry: f32 CG on
    poisson_2d(32) with b = 1 has an attainable residual above tol = 1e-6,
    so once the recurrence dips below the criterion each recheck fails and
    the history holds the explicit values.  Both backends do so from the
    same step with equal histories; the reference does so too (in f32 the
    dip itself moves by some steps between the packages, so their histories
    are compared over the first 30 steps, at rtol 1e-4)."""
    tol, maxiter = 1e-6, 120
    hist = {}
    for backend in ("eager", "while_loop"):
        rec = []
        _, info = kt.cg(
            ts.poisson_2d(32, dtype=np.float32), torch.ones(32, 32),
            inner=lambda u, v: torch.sum(u * v), tol=tol, maxiter=maxiter,
            callback=lambda x, r: rec.append(float(torch.linalg.norm(r))),
            backend=backend,
        )
        assert not info.success and info.numsteps == maxiter
        rec = np.asarray(rec)
        hist[backend] = (_first_overwrite(rec, info.resnorms, tol * rec[0]), info)
    (k_e, info_e), (k_w, info_w) = hist["eager"], hist["while_loop"]
    assert k_e is not None and k_e == k_w
    np.testing.assert_array_equal(info_e.resnorms, info_w.resnorms)

    rec_j = []
    _, info_j = krylov_tpu.cg(
        js.poisson_2d(32, dtype=np.float32), jnp.ones((32, 32), jnp.float32),
        inner=lambda u, v: jnp.sum(u * v), tol=tol, maxiter=maxiter,
        callback=lambda x, r: rec_j.append(float(jnp.linalg.norm(r))),
    )
    want = np.asarray(info_j.resnorms)
    assert not info_j.success
    assert _first_overwrite(np.asarray(rec_j), want, tol * rec_j[0]) is not None
    np.testing.assert_allclose(info_e.resnorms[:30], want[:30], rtol=1e-4)


def test_x0_and_diagonal_preconditioners_match_reference():
    A, b = _golden()
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(100)
    d = 1.0 / np.diag(A)
    dl = 0.5 + rng.random(100)
    for backend in ("eager", "while_loop"):
        x, info = kt.cg(A, b, x0=x0, M=DiagonalOperator(torch.from_numpy(d)),
                        Ml=DiagonalOperator(torch.from_numpy(dl)), tol=1e-10,
                        backend=backend)
        xj, info_j = krylov_tpu.cg(
            A, b, x0=x0, M=krylov_tpu.DiagonalOperator(jnp.asarray(d)),
            Ml=krylov_tpu.DiagonalOperator(jnp.asarray(dl)), tol=1e-10,
        )
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10)
        assert_same_solve(info, info_j)


def test_jacobi_preconditioner_matches_reference():
    A, b = _golden()
    M = kt.jacobi_preconditioner(kt.as_operator(A))
    Mj = krylov_tpu.jacobi_preconditioner(krylov_tpu.as_operator(A))
    np.testing.assert_array_equal(M.d.numpy(), np.asarray(Mj.d))
    _, info = kt.cg(A, b, M=M)
    _, info_j = krylov_tpu.cg(A, b, M=Mj)
    assert_same_solve(info, info_j)


def test_grid_cg_matches_reference_while_loop():
    """Grid-shaped CG on poisson_2d with a full-contraction inner, against
    the reference's compiled backend."""
    rng = np.random.default_rng(2)
    b = rng.standard_normal((8, 16))
    for backend in ("eager", "while_loop"):
        x, info = kt.cg(ts.poisson_2d(8, 16), torch.from_numpy(b),
                        inner=lambda u, v: torch.sum(u * v), tol=1e-10,
                        backend=backend)
        xj, info_j = krylov_tpu.cg(js.poisson_2d(8, 16), jnp.asarray(b),
                                   inner=lambda u, v: jnp.sum(u * v), tol=1e-10,
                                   backend="while_loop")
        assert tuple(x.shape) == (8, 16)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)
        assert_same_solve(info, info_j)


def test_grid_cg_requires_inner():
    with pytest.raises(ValueError, match="explicit inner"):
        kt.cg(ts.poisson_2d(4, 8), torch.ones(4, 8))


def test_default_x0_shortcut_is_bitwise():
    """The skipped prologue matvec changes nothing: x0=None and an explicit
    zero x0 give bitwise-equal histories and iterates."""
    A = ts.poisson_2d(8, 16)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 16)))
    inner = lambda u, v: torch.sum(u * v)  # noqa: E731
    _, i0 = kt.cg(A, b, inner=inner, backend="while_loop")
    _, iz = kt.cg(A, b, inner=inner, x0=torch.zeros_like(b), backend="while_loop")
    np.testing.assert_array_equal(i0.resnorms, iz.resnorms)
    assert torch.equal(i0.xk, iz.xk)


def test_return_arnoldi_eager_matches_reference():
    A, b = _golden()
    _, info = kt.cg(A, b, maxiter=12, tol=1e-30, atol=0.0, return_arnoldi=True)
    _, info_j = krylov_tpu.cg(A, b, maxiter=12, tol=1e-30, atol=0.0,
                              return_arnoldi=True)
    V, H, P = info.arnoldi
    Vj, Hj, Pj = info_j.arnoldi
    assert len(V) == len(Vj) == len(P) == 13 and H.shape == Hj.shape
    np.testing.assert_allclose(H, np.asarray(Hj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(torch.stack(V).numpy(), np.stack(Vj), atol=1e-10)
    np.testing.assert_allclose(torch.stack(P).numpy(), np.stack(Pj), atol=1e-10)


def test_return_arnoldi_while_loop_not_ported():
    """The while_loop backend now records the Lanczos relation too: on the
    golden problem its (V, H, P) equal the eager backend's bit for bit."""
    A, b = _golden()
    _, iw = kt.cg(A, b, maxiter=12, tol=1e-30, atol=0.0, return_arnoldi=True,
                  backend="while_loop")
    _, ie = kt.cg(A, b, maxiter=12, tol=1e-30, atol=0.0, return_arnoldi=True)
    (Vw, Hw, Pw), (Ve, He, Pe) = iw.arnoldi, ie.arnoldi
    assert len(Vw) == len(Pw) == 13 and Hw.shape == He.shape == (13, 12)
    np.testing.assert_array_equal(Hw, He)
    assert torch.equal(torch.stack(Vw), torch.stack(Ve))
    assert torch.equal(torch.stack(Pw), torch.stack(Pe))


def _spd40():
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    return (q * np.linspace(1.0, 50.0, 40)) @ q.T, rng.standard_normal(40)


@pytest.mark.parametrize("problem", ["spd40", "poisson_2d_grid"])
def test_return_arnoldi_while_loop_matches_reference(problem):
    """(V, H, P) of the compiled backend against the reference's compiled
    backend and the port's eager one, f64: a 40x40 SPD matrix, and
    poisson_2d(8, 16) on grid vectors (H then carries the grid's trailing
    axis, as the reference's does)."""
    if problem == "spd40":
        A, b = _spd40()
        At, Aj, bt, bj, kw = A, A, b, jnp.asarray(b), {}
    else:
        b = np.random.default_rng(12).standard_normal((8, 16))
        At, Aj = ts.poisson_2d(8, 16), js.poisson_2d(8, 16)
        bt, bj = b, jnp.asarray(b)
        kw = {"inner": lambda u, v: torch.sum(u * v)}
    args = dict(maxiter=10, tol=1e-30, atol=0.0, return_arnoldi=True)
    _, iw = kt.cg(At, torch.from_numpy(bt), backend="while_loop", **args, **kw)
    _, ie = kt.cg(At, torch.from_numpy(bt), **args, **kw)
    kwj = {} if not kw else {"inner": lambda u, v: jnp.sum(u * v)}
    _, ij = krylov_tpu.cg(Aj, bj, backend="while_loop", **args, **kwj)
    (Vw, Hw, Pw), (Vj, Hj, Pj) = iw.arnoldi, ij.arnoldi
    assert iw.numsteps == int(ij.numsteps) == 10 and Hw.shape == np.asarray(Hj).shape
    np.testing.assert_allclose(Hw, np.asarray(Hj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(torch.stack(Vw).numpy(), np.stack(Vj), atol=1e-10)
    np.testing.assert_allclose(torch.stack(Pw).numpy(), np.stack(Pj), atol=1e-10)
    np.testing.assert_allclose(Hw, ie.arnoldi[1], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(torch.stack(Vw).numpy(), torch.stack(ie.arnoldi[0]).numpy(),
                               atol=1e-13)


def test_operator_normalization():
    A, b = _golden()
    assert isinstance(kt.as_operator(A), kt.MatrixOperator)
    assert kt.Product(kt.Identity(), kt.as_operator(A)).dtype == torch.float64

    class Wrapped:  # any object with @
        shape = A.shape

        def __matmul__(self, x):
            return torch.from_numpy(A) @ x

    x, info = kt.cg(Wrapped(), b)
    np.testing.assert_allclose(float(x.abs().sum()), GOLDEN_SUM, rtol=1e-11)

    import scipy.sparse

    # a scipy matrix routes to the portable CSROperator on the CPU
    sp = scipy.sparse.csr_matrix(A)
    assert type(kt.as_operator(sp)).__name__ == "CSROperator"
    x, info = kt.cg(sp, b)
    np.testing.assert_allclose(float(x.abs().sum()), GOLDEN_SUM, rtol=1e-11)


def test_complex_inner_imaginary_check():
    from krylov_tpu_torch._inner import ensure_real

    ok = torch.tensor(2.0 + 1e-12j, dtype=torch.complex128)
    assert ensure_real(ok).dtype == torch.float64
    with pytest.raises(ValueError, match="imaginary"):
        ensure_real(torch.tensor(2.0 + 0.5j, dtype=torch.complex128))
