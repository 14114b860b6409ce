"""krylov_tpu_torch.BlockJacobiPreconditioner held to
krylov_tpu.BlockJacobiPreconditioner on the CPU.

The single-device cases of ``tests/test_blockjacobi.py`` run through both
packages on the same inputs, made from a seed with numpy (float64): one
application (1-D and blocked right-hand sides, ragged tail, adjoint) within
rtol 1e-12 of the reference's; ``cg`` with the preconditioner on both
backends against the reference's solve, equal ``numsteps`` and resnorms
within rtol 1e-10; line Jacobi against point Jacobi on an anisotropic
problem; a float32 solve through the CSR kernels' route against the
reference's float64 trajectory within the port's 2e-3 band.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu_torch import _operators
from krylov_tpu_torch.ops.cuda_spmv import PETOperator

from .test_torch_gmres import assert_same

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

N_SIDE = 31
BACKENDS = ["eager", "while_loop"]


def _aniso(n=N_SIDE, eps=100.0):
    """``tests/test_blockjacobi.py``'s anisotropic Poisson: eps along the
    block direction."""
    I = scipy.sparse.identity(n, dtype=np.float64)
    T = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), dtype=np.float64)
    return (scipy.sparse.kron(I, eps * T) + scipy.sparse.kron(T, I)).tocsr()


A = _aniso()
N = A.shape[0]
B1 = np.random.default_rng(3).standard_normal(N)
BK = np.random.default_rng(4).standard_normal((N, 3))


def _pair(block, **kw):
    return (kt.BlockJacobiPreconditioner.from_scipy(A, block=block, **kw),
            krylov_tpu.BlockJacobiPreconditioner.from_scipy(A, block=block, **kw))


@pytest.mark.parametrize("block", [N_SIDE, 64, 1, 7])
@pytest.mark.parametrize("rhs", ["vector", "block"])
def test_application_matches_reference(block, rhs):
    Mt, Mj = _pair(block)
    assert Mt.shape == Mj.shape == (N, N) and Mt.block == Mj.block == block
    assert Mt.dtype == torch.float64 and Mt.hermitian
    r = B1 if rhs == "vector" else BK
    for t_op, j_op in ((Mt.__matmul__, Mj.__matmul__), (Mt.rmatvec, Mj.rmatvec)):
        got = t_op(torch.from_numpy(r)).numpy()
        want = np.asarray(j_op(r))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_inverses_match_reference_and_dtype():
    Mt, Mj = _pair(64, dtype=np.float32)
    assert Mt.dtype == torch.float32
    np.testing.assert_allclose(Mt._inv.numpy(), np.asarray(Mj._inv), rtol=1e-6, atol=1e-7)
    Mt, Mj = _pair(64)
    np.testing.assert_array_equal(Mt._inv.numpy(), np.asarray(Mj._inv))


def test_complex_adjoint_is_the_conjugate_transpose():
    rng = np.random.default_rng(5)
    n = 40
    C = scipy.sparse.csr_matrix(8.0 * np.eye(n) + rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n)))
    M = kt.BlockJacobiPreconditioner.from_scipy(C, block=8)
    u = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    v = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    lhs = torch.vdot(u, M @ v)
    rhs = torch.vdot(M.rmatvec(u), v)
    assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(lhs))


@functools.cache
def _reference(case):
    """The reference's solve of one case, shared by both backends' tests."""
    block, b = (N_SIDE, B1) if case == "line" else (64, BK)
    M = krylov_tpu.BlockJacobiPreconditioner.from_scipy(A, block=block)
    return krylov_tpu.cg(A, b, tol=1e-8, M=M, backend="while_loop")[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["line", "ragged_blocked"])
def test_cg_trajectory_matches_reference(case, backend):
    block, b = (N_SIDE, B1) if case == "line" else (64, BK)
    M = kt.BlockJacobiPreconditioner.from_scipy(A, block=block)
    sol, info = kt.cg(A, torch.from_numpy(b), tol=1e-8, M=M, backend=backend)
    assert_same(info, _reference(case))
    x_ref = scipy.sparse.linalg.spsolve(A.tocsc(), b)
    assert np.max(np.abs(sol.numpy() - x_ref)) < 1e-6


def test_matches_explicit_block_diagonal_inverse():
    M = kt.BlockJacobiPreconditioner.from_scipy(A, block=N_SIDE)
    _, info = kt.cg(A, torch.from_numpy(B1), tol=1e-8, M=M, backend="while_loop")
    blocks = [np.linalg.inv(A[i * N_SIDE:(i + 1) * N_SIDE, i * N_SIDE:(i + 1) * N_SIDE]
                            .toarray()) for i in range(N_SIDE)]
    _, info_ref = kt.cg(A, torch.from_numpy(B1), tol=1e-8,
                        M=torch.from_numpy(scipy.linalg.block_diag(*blocks)))
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(info.resnorms, info_ref.resnorms, rtol=1e-6)


def test_line_blocks_beat_point_jacobi_on_anisotropy():
    _, info_pt = kt.cg(A, torch.from_numpy(B1), tol=1e-8,
                       M=kt.jacobi_preconditioner(kt.as_operator(A)), maxiter=3000)
    M = kt.BlockJacobiPreconditioner.from_scipy(A, block=N_SIDE)
    sol, info = kt.cg(A, torch.from_numpy(B1), tol=1e-8, M=M, backend="while_loop")
    assert info.success and info.numsteps * 4 < info_pt.numsteps


def test_float32_through_the_csr_kernels_route():
    """float32 ``cg`` with the operator routed to ``PETOperator`` (the CSR
    kernels' plain versions here), held to the reference's float64
    trajectory: every resnorm within 2e-3 relative, numsteps within one."""
    A32 = _aniso(128).astype(np.float32)  # 16,384 rows, 81,152 entries: the PET route
    b = np.random.default_rng(6).standard_normal(A32.shape[0])
    # blocks of 64: numpy's batched inverse of 128 x 128 blocks can take
    # minutes on a host whose cores are all busy (threaded LAPACK)
    Mj = krylov_tpu.BlockJacobiPreconditioner.from_scipy(A32.astype(np.float64), block=64)
    _, ref = krylov_tpu.cg(A32.astype(np.float64), b, tol=1e-4, M=Mj, maxiter=400,
                           backend="while_loop")
    with mock.patch.object(_operators, "_pet_device", lambda device: True):
        assert isinstance(kt.as_operator(A32), PETOperator)
        M = kt.BlockJacobiPreconditioner.from_scipy(A32, block=64)
        _, info = kt.cg(A32, torch.from_numpy(b.astype(np.float32)), tol=1e-4, M=M,
                        maxiter=400, backend="while_loop")
    assert info.success and abs(info.numsteps - int(ref.numsteps)) <= 1
    n = min(len(info.resnorms), len(ref.resnorms))
    want = np.asarray(ref.resnorms)[:n]
    assert np.max(np.abs(info.resnorms[:n] - want) / want) <= 2e-3


def test_from_reference():
    Mj = krylov_tpu.BlockJacobiPreconditioner.from_scipy(A, block=64)
    Mt = kt.convert.from_reference(Mj)
    assert isinstance(Mt, kt.BlockJacobiPreconditioner) and Mt.shape == (N, N)
    np.testing.assert_allclose((Mt @ torch.from_numpy(BK)).numpy(), np.asarray(Mj @ BK),
                               rtol=1e-12, atol=1e-14)


def test_guards():
    with pytest.raises(ValueError, match="square"):
        kt.BlockJacobiPreconditioner.from_scipy(
            scipy.sparse.random(8, 5, density=0.5, format="csr"))
    with pytest.raises(ValueError, match="positive"):
        kt.BlockJacobiPreconditioner.from_scipy(A, block=0)
