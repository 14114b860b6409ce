"""krylov_tpu_torch.bicgstab and the drivers' early_success, held to
krylov_tpu on the CPU.

Every ``bicgstab*`` entry of ``tests/fixtures/golden.json`` is replayed
through the port on both backends within ``test_golden.py``'s bands
(``LOOSE_CASES`` included); a Jacobi-preconditioned solve that leaves
through the mid-step exit, and the drivers' ``early_success`` contract on a
synthetic method, are compared with the reference package (float64).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import _driver as jdriver
from krylov_tpu_torch import _driver as tdriver

from .test_golden import GOLDEN
from .test_torch_gmres import assert_same, replay_golden

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

BICGSTAB_KEYS = sorted(k for k in GOLDEN if k.startswith("bicgstab"))


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("key", BICGSTAB_KEYS)
def test_golden(key, backend):
    replay_golden(key, kt.bicgstab, backend)


def _shifted_poisson(n=300, shift=0.5):
    """The reference bench's 1-D-offset shifted Laplacian, at a small size."""
    g = int(np.sqrt(n))
    return scipy.sparse.diags(
        [-1.0, -1.0, 4.0 + shift, -1.0, -1.0], [-g, -1, 0, 1, g],
        shape=(n, n), format="csr",
    )


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_jacobi_solve_leaves_early_as_reference(backend):
    """With Ml = diag(A)^-1 the mid-step probe measures Ml twice, so the
    solve ends through early_success: the last history entry is the probe
    of the returned iterate, not an explicit recheck."""
    A = _shifted_poisson()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    dinv = 1.0 / A.diagonal()
    Mt = kt.DiagonalOperator(torch.from_numpy(dinv))
    seen_t, seen_j = [], []
    x, it = kt.bicgstab(A, b, Ml=Mt, tol=1e-8, backend=backend,
                        callback=lambda *a: seen_t.append(1))
    _, ij = krylov_tpu.bicgstab(A, b, Ml=krylov_tpu.DiagonalOperator(jnp.asarray(dinv)),
                                tol=1e-8, callback=lambda *a: seen_j.append(1))
    assert it.success
    assert_same(it, ij, rtol=1e-9)
    assert len(seen_t) == len(seen_j) == it.numsteps + 1
    r = b - A @ x.numpy()
    probe = np.sqrt(np.vdot(dinv * r, dinv * dinv * r).real)
    explicit = np.sqrt(np.vdot(r, dinv * r).real)
    assert it.resnorms[-1] == pytest.approx(probe, rel=1e-9)
    assert not np.isclose(probe, explicit, rtol=1e-3)


class _S(NamedTuple):
    x: object
    resnorm: object
    early_success: object


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
@pytest.mark.parametrize("early_at,maxiter", [(3, 10), (5, 5), (None, 6)])
def test_early_success_matches_reference_drivers(early_at, maxiter, backend):
    """The early step overwrites the last history entry (nothing appended),
    fires no callback, is not rechecked, and declares success; the same
    numsteps, callback count and history as the reference's drivers."""

    def run(lib, arr, driver, jbackend):
        def step(s, criterion):
            x = s.x + 1
            early = (x == early_at) if early_at is not None else (x < 0)
            return _S(x, s.resnorm * 0.5 + 0.01 * x, early)

        calls = []
        method = driver.Method(
            step=step, xk=lambda s: s.x,
            explicit_resnorm=lambda x: arr(1e-9) * x,
            callback_args=lambda s: (s.x,),
        )
        s0 = _S(arr(0.0), arr(1.0), arr(False))
        state, success, k, hist = driver.run(
            s0, method, tol=1e-12, atol=0.0, maxiter=maxiter,
            callback=lambda *a: calls.append(1), backend=jbackend)
        return bool(success), int(k), np.asarray(hist), len(calls), float(state.x)

    got = run(torch, lambda v: torch.tensor(v, dtype=torch.float64 if
                                            isinstance(v, float) else None),
              tdriver, backend)
    want = run(jnp, lambda v: jnp.asarray(v, jnp.float64 if isinstance(v, float)
                                          else None), jdriver, backend)
    assert got[:2] == want[:2] and got[3:] == want[3:]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-15)
    if early_at is not None:
        # the early step is not counted and fires no callback
        assert got[0] and got[1] == early_at - 1 and got[3] == early_at - 1


def test_blocked_rhs_and_right_preconditioner_match_reference():
    rng = np.random.default_rng(3)
    n = 30
    A = np.diag(np.linspace(2.0, 4.0, n)) + 0.2 * rng.standard_normal((n, n)) / np.sqrt(n)
    B = rng.standard_normal((n, 2))
    Mr = np.diag(1.0 / np.diag(A))
    for backend in ("eager", "while_loop"):
        x, it = kt.bicgstab(A, B, Mr=Mr, tol=1e-10, backend=backend)
        _, ij = krylov_tpu.bicgstab(A, B, Mr=Mr, tol=1e-10)
        assert tuple(x.shape) == B.shape
        assert_same(it, ij, rtol=1e-9)
