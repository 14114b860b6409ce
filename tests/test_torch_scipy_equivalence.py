"""``tests/test_scipy_equivalence.py``'s trajectory cases over the port on
the CPU: the port's explicit-residual trajectories against scipy's, entry
by entry, on the same problems, preconditioner conventions and bands, and
``tests/helpers.py``'s consistency invariants on every converged
unpreconditioned solve (a preconditioned history holds preconditioned
norms, which the invariant's explicit 2-norm does not)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import krylov_tpu_torch as kt

from . import test_scipy_equivalence as ref
from .helpers import assert_consistent

kt.set_default_device("cpu")


@pytest.mark.parametrize(
    "ours,theirs,prob,our_prec,sp_prec", ref._CASES,
    ids=[f"{c[0]}-{c[2]}-{c[3] or 'noprec'}" for c in ref._CASES],
)
def test_port_trajectory_matches_scipy(ours, theirs, prob, our_prec, sp_prec):
    A, b = ref._PROBLEMS[prob]()
    maxiter = 12
    our_kw, sp_kw = {}, {}
    if our_prec is not None:
        M = ref._jacobi_ish(A)
        our_kw[our_prec] = M
        if sp_prec == "M2":
            sp_kw["M1"] = spla.aslinearoperator(np.eye(A.shape[0]))
            sp_kw["M2"] = spla.aslinearoperator(M)
        else:
            sp_kw[sp_prec] = M

    want, x_ref = ref._scipy_trajectory(getattr(spla, theirs), A, b, maxiter, **sp_kw)
    got, info = ref._our_trajectory(getattr(kt, ours), A, b, maxiter, **our_kw)

    m = min(len(want), len(got))
    assert m >= 3, f"trajectories too short to be meaningful: {m}"
    np.testing.assert_allclose(got[:m], want[:m], rtol=1e-7, atol=1e-10)
    if info.success:
        np.testing.assert_allclose(info.xk.numpy(), x_ref, rtol=1e-6, atol=1e-9)
        if our_prec is None:
            sol, info = getattr(kt, ours)(A, b, tol=1e-12, atol=0.0, maxiter=maxiter)
            assert_consistent(A, b, info, sol, 1e-10)


def test_port_gmres_solution_matches_scipy():
    A, b = ref._unsym()
    x_ref, _ = spla.gmres(A, b, rtol=1e-12, atol=0.0, maxiter=5, restart=5)
    _, info = kt.gmres(A, b, tol=1e-12, atol=0.0, maxiter=5)
    np.testing.assert_allclose(info.xk.numpy(), x_ref, rtol=1e-6, atol=1e-9)
