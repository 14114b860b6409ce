"""krylov_tpu_torch.ILUPreconditioner held to krylov_tpu.ILUPreconditioner
on the CPU.

The cases of ``tests/test_ilu.py`` run through both packages on the same
inputs, made from a seed with numpy (float64): the ILU(0) factors equal the
reference's bit for bit (the same native numerics); one application and
one adjoint application of ILU(0) and ILUT within rtol 1e-12 of the
reference's and of ``SuperLU.solve``; ``bicgstab`` and ``gmres`` with ILU as
``Ml``, ``qmr`` with ``with_rmatvec=True`` and ``cg`` with ILU(0) as ``M``,
on both backends, against the reference's solve (equal ``numsteps``,
resnorms within rtol 1e-10); a float32 ``cg`` through the CSR kernels'
route against the reference's float64 trajectory within the port's
2e-3 band.  The reference's solves run compiled (``while_loop``), once each:
its eager driver retraces the sweeps' scans at every application.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import ilu as jilu
from krylov_tpu_torch import _operators
from krylov_tpu_torch import ilu as tilu
from krylov_tpu_torch.ops.cuda_spmv import PETOperator

from .test_torch_gmres import assert_same

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

BACKENDS = ["eager", "while_loop"]


def _convection_diffusion(n=24, pe=20.0):
    h = 1.0 / (n + 1)
    T = scipy.sparse.diags([-1 - pe * h / 2, 2.0, -1 + pe * h / 2], [-1, 0, 1], shape=(n, n))
    I = scipy.sparse.identity(n)
    return (scipy.sparse.kron(I, T) + scipy.sparse.kron(T, I)).tocsr()


A = _convection_diffusion()
S = _convection_diffusion(pe=0.0)  # the SPD Poisson
N = A.shape[0]
RNG = np.random.default_rng(11)
B1 = RNG.standard_normal(N)
BK = RNG.standard_normal((N, 3))


def test_ilu0_factors_equal_reference():
    for M in (A, S):
        (Lt, Ut), (Lj, Uj) = tilu._ilu0_factor(M), jilu._ilu0_factor(M)
        for t, j in ((Lt, Lj), (Ut, Uj)):
            assert abs(t - j).max() == 0.0 and t.nnz == j.nnz


def test_ilu0_defining_property():
    """(LU)_ij == A_ij on A's pattern, and the factors' depth is the grid
    wavefront: 2 * 24 - 1 levels."""
    L, U = tilu._ilu0_factor(A)
    mask = A.copy()
    mask.data = np.ones_like(mask.data)
    diff = (L @ U).multiply(mask) - A
    assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-12
    M = kt.ILUPreconditioner.from_scipy(A)
    assert M.nlevels == (47, 47) and M.shape == (N, N) and M.dtype == torch.float64


@pytest.mark.parametrize("method", ["ilu0", "ilut"])
@pytest.mark.parametrize("rhs", ["vector", "block"])
def test_application_matches_reference(method, rhs):
    Mt = kt.ILUPreconditioner.from_scipy(A, method=method, with_rmatvec=True)
    Mj = krylov_tpu.ILUPreconditioner.from_scipy(A, method=method, with_rmatvec=True)
    assert Mt.nlevels == Mj.nlevels
    r = B1 if rhs == "vector" else BK
    for t_op, j_op in ((Mt.__matmul__, Mj.__matmul__), (Mt.rmatvec, Mj.rmatvec)):
        np.testing.assert_allclose(t_op(torch.from_numpy(r)).numpy(), np.asarray(j_op(r)),
                                   rtol=1e-12, atol=1e-14)


def test_ilut_apply_matches_superlu_solve():
    ilu = scipy.sparse.linalg.spilu(A.tocsc())
    M = kt.ILUPreconditioner.from_scipy(A, method="ilut")
    np.testing.assert_allclose(M @ torch.from_numpy(B1), ilu.solve(B1), rtol=1e-12, atol=1e-14)
    Z = (M @ torch.from_numpy(BK)).numpy()
    for j in range(3):
        np.testing.assert_allclose(Z[:, j], ilu.solve(BK[:, j]), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["ilu0", "ilut"])
def test_rmatvec_is_the_adjoint(method):
    M = kt.ILUPreconditioner.from_scipy(A, method=method, with_rmatvec=True)
    u, v = torch.from_numpy(RNG.standard_normal(N)), torch.from_numpy(RNG.standard_normal(N))
    lhs, rhs = float(u @ (M @ v)), float(M.rmatvec(u) @ v)
    assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))
    with pytest.raises(ValueError, match="with_rmatvec"):
        kt.ILUPreconditioner.from_scipy(A, method=method).rmatvec(u)


@functools.cache
def _reference(solver):
    """The reference's compiled solve for one case, shared by both
    backends' tests (ILU(0) as ``M`` of cg on the SPD Poisson, as ``Ml``
    of the others on the convection-diffusion matrix)."""
    if solver == "cg":
        M = krylov_tpu.ILUPreconditioner.from_scipy(S)
        return krylov_tpu.cg(S, B1, tol=1e-8, M=M, backend="while_loop")[1]
    M = krylov_tpu.ILUPreconditioner.from_scipy(A, with_rmatvec=True)
    return getattr(krylov_tpu, solver)(A, B1, tol=1e-8, Ml=M, maxiter=100,
                                       backend="while_loop")[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("solver", ["bicgstab", "gmres", "qmr"])
def test_left_preconditions_nonsymmetric_family(solver, backend):
    M = kt.ILUPreconditioner.from_scipy(A, with_rmatvec=solver == "qmr")
    sol, info = getattr(kt, solver)(A, torch.from_numpy(B1), tol=1e-8, Ml=M, maxiter=100,
                                    backend=backend)
    assert info.success
    assert_same(info, _reference(solver))
    x_ref = scipy.sparse.linalg.spsolve(A.tocsc(), B1)
    assert np.max(np.abs(sol.numpy() - x_ref)) < 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_ilu0_is_spd_preconditioner_for_cg(backend):
    """On SPD input ILU(0) is L D L^T (IC(0)): a valid CG ``M``, symmetric
    to rounding, with far fewer steps than Jacobi."""
    L, U = tilu._ilu0_factor(S)
    P = (L @ U).toarray()
    assert np.abs(P - P.T).max() < 1e-12
    M = kt.ILUPreconditioner.from_scipy(S)
    sol, info = kt.cg(S, torch.from_numpy(B1), tol=1e-8, M=M, backend=backend)
    assert_same(info, _reference("cg"))
    _, i_j = kt.cg(S, torch.from_numpy(B1), tol=1e-8, M=kt.jacobi_preconditioner(kt.as_operator(S)))
    assert info.success and info.numsteps * 2 < i_j.numsteps
    x_ref = scipy.sparse.linalg.spsolve(S.tocsc(), B1)
    assert np.max(np.abs(sol.numpy() - x_ref)) < 1e-6


def test_float32_through_the_csr_kernels_route():
    """float32 ``cg`` with ILU(0) as ``M`` and the operator routed to
    ``PETOperator`` (the CSR kernels' plain versions here), held to the
    reference's float64 trajectory: every resnorm within 2e-3 relative,
    numsteps within one."""
    S64 = _convection_diffusion(120, pe=0.0)  # 14,400 rows, 71,520 entries: the PET route
    S32 = S64.astype(np.float32)
    b = np.random.default_rng(12).standard_normal(S64.shape[0])
    Mj = krylov_tpu.ILUPreconditioner.from_scipy(S64)
    _, ref = krylov_tpu.cg(S64, b, tol=1e-4, M=Mj, maxiter=200, backend="while_loop")
    with mock.patch.object(_operators, "_pet_device", lambda device: True):
        assert isinstance(kt.as_operator(S32), PETOperator)
        M = kt.ILUPreconditioner.from_scipy(S32)
        assert M.dtype == torch.float32
        _, info = kt.cg(S32, torch.from_numpy(b.astype(np.float32)), tol=1e-4, M=M,
                        maxiter=200, backend="while_loop")
    assert info.success and abs(info.numsteps - int(ref.numsteps)) <= 1
    n = min(len(info.resnorms), len(ref.resnorms))
    want = np.asarray(ref.resnorms)[:n]
    assert np.max(np.abs(info.resnorms[:n] - want) / want) <= 2e-3


def test_ilu0_complex_matrix_keeps_imaginary_part():
    C = (A.astype(np.complex128)
         + 1j * scipy.sparse.diags(0.1 * np.ones(N - 1), 1, shape=(N, N)).tocsr()).tocsr()
    L, U = tilu._ilu0_factor(C)
    mask = C.copy()
    mask.data = np.ones_like(mask.data)
    diff = (L @ U).multiply(mask) - C
    assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-12
    r = RNG.standard_normal(N) + 1j * RNG.standard_normal(N)
    np.testing.assert_allclose(
        kt.ILUPreconditioner.from_scipy(C) @ torch.from_numpy(r),
        np.asarray(krylov_tpu.ILUPreconditioner.from_scipy(C) @ r), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["ilu0", "ilut"])
def test_from_reference(method):
    Mj = krylov_tpu.ILUPreconditioner.from_scipy(A, method=method, with_rmatvec=True)
    Mt = kt.convert.from_reference(Mj)
    assert isinstance(Mt, kt.ILUPreconditioner) and Mt.nlevels == Mj.nlevels
    r = torch.from_numpy(BK)
    np.testing.assert_allclose(Mt @ r, np.asarray(Mj @ BK), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(Mt.rmatvec(r), np.asarray(Mj.rmatvec(BK)), rtol=1e-12,
                               atol=1e-14)
    assert kt.convert.from_reference(krylov_tpu.ILUPreconditioner.from_scipy(A))._adj is None


def test_guards():
    with pytest.raises(NotImplementedError, match="levels"):
        kt.ILUPreconditioner.from_scipy(A, max_levels=4)
    with pytest.raises(ValueError, match="unknown method"):
        kt.ILUPreconditioner.from_scipy(A, method="ilu1")
