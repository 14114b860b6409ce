"""krylov_tpu_torch.qmr, bicg, cgs and tfqmr held to krylov_tpu on the CPU.

Every ``qmr*``, ``bicg*`` (not bicgstab) and ``cgs*`` entry of
``tests/fixtures/golden.json`` is replayed through the port on both
backends within ``test_golden.py``'s bands (``LOOSE_CASES`` included), and
one solve per solver and variant (preconditioned, blocked ``(N, 3)``
right-hand side, complex matrix, custom inner product, unconverged) is
compared with the reference package on the same inputs, made from a seed
with numpy (float64): equal ``numsteps`` and callback counts, histories
within rtol 1e-9, equal solutions.  ``tfqmr`` has no golden entries: it
takes the problems of the reference's ``tests/test_tfqmr.py`` besides.

This module also holds the harness the other solver-family files share
(``problem``, ``variant_args``, ``check_variant``, ``golden_keys``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch as kt

from .test_golden import GOLDEN
from .test_torch_gmres import assert_same, replay_golden

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

BACKENDS = ["eager", "while_loop"]


def golden_keys(*names):
    """The golden entries of the solvers ``names`` (``name`` or ``name_variant``)."""
    return sorted(k for k in GOLDEN
                  if k.split("/")[0] in names
                  or k.split("/")[0].rsplit("_", 1)[0] in names)


def problem(kind, n=40, seed=0):
    """Well-conditioned seeded test systems ``(A, b, B)`` with ``B`` of
    shape ``(n, 3)``: a diagonal in [1, 3] plus a small dense perturbation,
    so every method converges in a few dozen steps and rounding differences
    between the two packages are not amplified."""
    rng = np.random.default_rng(seed)
    E = 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    D = np.diag(np.linspace(1.0, 3.0, n))
    if kind == "spd":
        A = D + 0.5 * (E + E.T)
    elif kind == "nonsym":
        A = D + E
    elif kind == "hpd":
        F = 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
        A = D + 0.5 * (E + E.T) + 0.5j * (F - F.T)
    elif kind == "complex":
        F = 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
        A = D + E + 1j * F
    else:
        raise KeyError(kind)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 3))
    if np.iscomplexobj(A):
        b = b + 0.5j * rng.standard_normal(n)
    return A, b, B


def weighted_inner(n, xp, uniform=False):
    """``<x, y>_w = sum_i conj(x_i) w_i y_i`` with positive seeded weights,
    for ``xp`` = ``jnp`` or ``torch``: the same numbers in both packages.
    ``uniform`` makes all weights 2.5: the two-sided methods need
    ``rmatvec`` to be the adjoint in the inner product they are given."""
    w = np.full(n, 2.5) if uniform else 1.0 + np.random.default_rng(7).random(n)
    wx = jnp.asarray(w) if xp is jnp else torch.from_numpy(w)

    def inner(x, y):
        ww = wx.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x.conj() * (ww * y)).sum(0)

    return inner


def variant_args(variant, kind, precond, uniform_inner=False, n=40):
    """``(A, b, kwargs_for(xp))`` of one variant of the shared sweep.

    ``precond`` names the solver's preconditioner keywords: each gets the
    Jacobi matrix ``diag(A)^-1`` (for two names, its square root twice)."""
    A, b, B = problem("hpd" if variant == "complex" and kind == "spd"
                      else "complex" if variant == "complex" else kind, n=n)
    kw = dict(tol=1e-8)
    if variant == "precond":
        d = 1.0 / np.diag(A).real
        for name in precond:
            kw[name] = np.diag(d if len(precond) == 1 else np.sqrt(d))
    elif variant == "blocked":
        b = B
    elif variant == "unconverged":
        kw.update(tol=1e-30, atol=0.0, maxiter=4)

    def kwargs_for(xp):
        out = dict(kw)
        if variant == "inner":
            out["inner"] = weighted_inner(n, xp, uniform_inner)
        return out

    return A, b, kwargs_for


VARIANTS = ["plain", "precond", "blocked", "complex", "inner", "unconverged"]


@functools.cache
def reference_solve(name, variant, kind, precond, extra=(), uniform_inner=False,
                    n=40):
    """The reference's solve of one variant, shared by both backends' tests
    (eager: its compile time would dominate this file's run time)."""
    A, b, kwargs_for = variant_args(variant, kind, precond, uniform_inner, n)
    calls = []
    sol, info = getattr(krylov_tpu, name)(
        A, b, callback=lambda *a: calls.append(1), **dict(extra), **kwargs_for(jnp))
    return sol, info, len(calls)


def check_variant(name, variant, kind, precond, backend, extra=(), rtol=1e-9,
                  uniform_inner=False, n=40):
    """One variant of solver ``name`` on the port against the reference:
    success, numsteps, callback count, history, solution, and ``(None,
    info)`` for an unconverged solve."""
    A, b, kwargs_for = variant_args(variant, kind, precond, uniform_inner, n)
    calls = []
    sol, info = getattr(kt, name)(
        A, b, callback=lambda *a: calls.append(1), backend=backend,
        **dict(extra), **kwargs_for(torch))
    sol_j, info_j, ncalls_j = reference_solve(name, variant, kind, precond, extra,
                                              uniform_inner, n)
    assert_same(info, info_j, rtol=rtol)
    assert len(calls) == ncalls_j == info.numsteps + 1
    if variant == "unconverged":
        assert sol is None and sol_j is None and not info.success
    else:
        assert info.success and tuple(sol.shape) == b.shape
        assert info.resnorms.shape == (info.numsteps + 1,) + b.shape[1:]


# solver -> (problem kind, preconditioner keywords)
TWOSIDED = {
    "qmr": ("nonsym", ("Ml", "Mr")),
    "bicg": ("nonsym", ("M",)),
    "cgs": ("nonsym", ("M",)),
    "tfqmr": ("nonsym", ("M",)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("key", golden_keys("qmr", "bicg", "cgs"))
def test_golden(key, backend):
    replay_golden(key, getattr(kt, key.split("/")[0].split("_")[0]), backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(TWOSIDED))
def test_matches_reference(name, variant, backend):
    kind, precond = TWOSIDED[name]
    check_variant(name, variant, kind, precond, backend,
                  uniform_inner=name in ("qmr", "bicg"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bicg_callback_gets_the_residual_pair(backend):
    A, b, _ = problem("nonsym")
    seen = []
    kt.bicg(A, b, tol=1e-8, backend=backend, callback=lambda x, r: seen.append(r.shape))
    assert set(seen) == {(2, 40)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_twosided_solvers_use_the_adjoint(backend):
    """qmr and bicg apply ``A^H`` through ``rmatvec`` once per step (an
    operator without a usable transpose would fail)."""

    class Counting:
        shape = (40, 40)
        dtype = torch.float64

        def __init__(self, a):
            self.a, self.fwd, self.adj = torch.from_numpy(a), 0, 0

        def __matmul__(self, x):
            self.fwd += 1
            return self.a @ x

        def rmatvec(self, x):
            self.adj += 1
            return self.a.mH @ x

    A, b, _ = problem("nonsym")
    for fn in (kt.qmr, kt.bicg):
        op = Counting(A)
        _, info = fn(op, b, tol=1e-8, backend=backend)
        assert info.success and op.adj == info.numsteps
        assert op.fwd >= info.numsteps


# --- tfqmr: the problems of the reference's own tests ------------------------


def _tfqmr_system(n=60, seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 5.0, n)) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tfqmr_quasi_residual_bounds_the_true_one(backend):
    A, b = _tfqmr_system()
    true = []
    _, info = kt.tfqmr(A, b, tol=1e-10, backend=backend, callback=lambda x, w: true.append(
        np.linalg.norm(b - A @ x.numpy())))
    _, info_j = krylov_tpu.tfqmr(A, b, tol=1e-10)
    assert info.success
    assert_same(info, info_j, rtol=1e-9)
    # every entry but the last (the explicit residual) is an upper bound
    assert np.all(np.asarray(true[1:-1]) <= info.resnorms[1:-1] * (1 + 1e-8))


def test_tfqmr_maxiter_counts_half_steps():
    A, b = _tfqmr_system(n=12)
    # default: two half-steps per Krylov dimension
    _, info = kt.tfqmr(A, b, tol=1e-30, atol=0.0)
    assert info.numsteps == 24 and not info.success
    # an explicit maxiter, N included, is not doubled
    _, info = kt.tfqmr(A, b, tol=1e-30, atol=0.0, maxiter=12)
    assert info.numsteps == 12


def test_tfqmr_takes_a_matvec_only_operator():
    A, b = _tfqmr_system()

    class MatvecOnly:
        shape = A.shape
        dtype = torch.float64

        def __matmul__(self, x):
            return torch.from_numpy(A) @ x

    x, info = kt.tfqmr(MatvecOnly(), b, tol=1e-10, backend="while_loop")
    assert info.success
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-8)
