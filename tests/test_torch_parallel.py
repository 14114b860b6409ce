"""krylov_tpu_torch.parallel held to krylov_tpu.parallel on the CPU.

The port's sharded solves run on four gloo ranks (processes of one
module-scoped pool, :class:`krylov_tpu_torch.parallel._spawn.SPMDPool`);
the reference's on a four-device mesh of the conftest's virtual CPU
devices.  Inputs are made from a seed with numpy and go through both.  In
float64 a case holds the port to the reference at equal ``numsteps``,
resnorms within rtol 1e-9 and ``xk`` within rtol 1e-8, and to the port's
own single-device solve; float32 cases (the PET partitions) hold both to
the reference's own f32 band for sharded runs, rtol 2e-3 and one step
(``__graft_entry__.py``).  Every rank returns the same ``x`` and ``Info``
(the pool checks it).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import bsr as jbsr
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.ops import bsr as tbsr
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.parallel import _spawn
from krylov_tpu_torch.parallel.solve import _pad_banded

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

RANKS = 4
F32_RTOL = 2e-3  # the reference's band for f32 sharded trajectories


@pytest.fixture(scope="module")
def pool():
    with _spawn.SPMDPool(RANKS, timeout=120.0) as p:
        yield p


def _jmesh(n_rhs=1):
    return jpar.make_mesh(n_rows=RANKS // n_rhs, n_rhs=n_rhs)


def ref_solve(solver, A, b, n_rhs=1, **kw):
    """The reference's sharded solve on four virtual devices."""
    _, info = jpar.sharded_solve(getattr(krylov_tpu, solver), A, jnp.asarray(b),
                                 mesh=_jmesh(n_rhs), **kw)
    return info


def port_solve(pool, solver, A, b, n_rhs=1, **kw):
    """The port's sharded solve, sent to the ranks: the reference's solve
    (in this process) runs while they work; ``held`` collects it."""
    return pool.submit(_spawn.solve_job, getattr(kt, solver), A, b, mesh_rows=RANKS // n_rhs,
                       mesh_rhs=n_rhs, **kw)


def _done(res):
    return res.result() if isinstance(res, _spawn.SPMDJob) else res


def held(res, ref, rtol=1e-9, x_rtol=1e-8, steps=0):
    """The port's sharded result ``res`` against an ``Info`` (or the
    ``info`` triple of another sharded result)."""
    res, ref = _done(res), _done(ref)
    success, numsteps, resnorms = res["info"]
    if isinstance(ref, dict):
        r_success, r_steps, r_res = ref["info"]
        r_x = ref["x"]
    else:
        r_success, r_steps, r_res = bool(ref.success), int(ref.numsteps), np.asarray(ref.resnorms)
        r_x = np.asarray(ref.xk)
    assert success == r_success
    assert abs(numsteps - r_steps) <= steps, (numsteps, r_steps)
    m = min(len(resnorms), len(r_res))
    np.testing.assert_allclose(resnorms[:m], r_res[:m], rtol=rtol,
                               atol=1e-12 * float(np.max(np.abs(r_res[0]))))
    if steps == 0:
        np.testing.assert_allclose(res["x"], r_x, rtol=x_rtol,
                                   atol=x_rtol * float(np.max(np.abs(r_x))))
    return res


def single(solver, A, b, rtol=1e-8, **kw):
    """The port's single-device solve (``while_loop``)."""
    b = torch.as_tensor(b)
    if isinstance(A, (tst.GridStencilOperator, tst.ConstStencilOperator)) and b.ndim >= 2 \
            and tuple(b.shape[:2]) == tuple(A.grid):
        kw.setdefault("inner", lambda u, v: torch.sum(u.conj() * v, dim=(0, 1)))
    return getattr(kt, solver)(A, b, backend="while_loop", **kw)[1]


def also_single(res, info, rtol=1e-8, steps=0):
    held(res, info, rtol=rtol, x_rtol=1e-7, steps=steps)


def _rng(seed):
    return np.random.default_rng(seed)


def _banded_pair(coeffs, offsets, hermitian):
    return (jst.BandedOperator(jnp.asarray(coeffs), offsets, hermitian=hermitian),
            tst.BandedOperator(torch.as_tensor(coeffs), offsets, hermitian=hermitian))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def test_banded_matvec_matches_reference(pool):
    Aj, At = jst.poisson_2d(8, 16), tst.poisson_2d(8, 16)
    banded = tst.BandedOperator(At.coeffs.clone(), At.offsets, hermitian=True)
    x = _rng(0).standard_normal(128)
    got = pool.run(_spawn.apply_job, banded, x)["x"]
    np.testing.assert_allclose(got, np.asarray(Aj @ jnp.asarray(x)), atol=1e-13)


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (0, 1), (-1, 0), (0, 1, 2), (-2, -1, 0)])
def test_banded_rmatvec_matches_reference(pool, offsets):
    """Non-symmetric bands, one-sided ones included: the adjoint's halo
    widths mirror the matvec's."""
    n = 64
    rng = _rng(21)
    coeffs = np.zeros((len(offsets), n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), n - max(0, off)
        coeffs[d, lo:hi] = rng.standard_normal(hi - lo)
    Aj, At = _banded_pair(coeffs, offsets, hermitian=False)
    x = rng.standard_normal(n)
    got = pool.run(_spawn.apply_job, At, x, adjoint=True)["x"]
    np.testing.assert_allclose(got, np.asarray(Aj.rmatvec(jnp.asarray(x))), atol=1e-13)


@pytest.mark.parametrize("shape", [(16, 16), (32, 16), (8, 16)])
def test_grid_matvec_matches_reference(pool, shape):
    """4 ranks: 4 and 8 rows a slab take the overlapped path (the slab with
    zero halos, then the boundary strips), 2 rows the dependent one."""
    Aj, At = jst.poisson_2d(*shape), tst.poisson_2d(*shape)
    x2 = _rng(10).standard_normal(shape)
    got = pool.run(_spawn.apply_job, At, x2)["x"]
    np.testing.assert_allclose(got, np.asarray(Aj @ jnp.asarray(x2)), atol=1e-13)
    xk = _rng(11).standard_normal(shape + (3,))
    got = pool.run(_spawn.apply_job, At, xk)["x"]
    np.testing.assert_allclose(got, np.asarray(Aj @ jnp.asarray(xk)), atol=1e-13)


def test_const_matvec_matches_reference(pool):
    Aj = jst.poisson_2d_const(16, 16, dtype=np.float64)
    At = tst.poisson_2d_const(16, 16, dtype=np.float64)
    x2 = _rng(30).standard_normal((16, 16))
    got = pool.run(_spawn.apply_job, At, x2)["x"]
    np.testing.assert_allclose(got, np.asarray(Aj @ jnp.asarray(x2)), atol=1e-13)


@pytest.mark.parametrize("pattern", ["banded", "random"])
def test_csr_rmatvec_both_modes(pool, pattern):
    rng = _rng(6)
    if pattern == "banded":
        sp = scipy.sparse.diags([rng.random(63), 2 + rng.random(64), rng.random(63)],
                                [-1, 0, 1], format="csr")
    else:
        sp = scipy.sparse.random(64, 64, density=0.2, random_state=7, format="csr")
    mode = tpar.partition_csr(sp, RANKS)["mode"]
    assert mode == jpar.partition_csr(sp, RANKS)["mode"]
    assert mode == ("halo" if pattern == "banded" else "gather")
    x = rng.standard_normal(64)
    for adjoint, want in ((False, sp @ x), (True, sp.T.conj() @ x)):
        got = pool.run(_spawn.apply_job, sp, x, adjoint=adjoint)["x"]
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_bsr_rmatvec_matches_dense(pool):
    dense, _ = _block_dense()
    At = tbsr.BSROperator.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(32, 32))
    x = _rng(61).standard_normal(dense.shape[0])
    got = pool.run(_spawn.apply_job, At, x, adjoint=True)["x"]
    np.testing.assert_allclose(got, dense.T @ x, atol=1e-10)
    got = pool.run(_spawn.apply_job, At, x)["x"]
    np.testing.assert_allclose(got, dense @ x, atol=1e-10)


def test_pad_banded_adds_a_unit_diagonal():
    n2 = 10
    c2 = np.zeros((2, n2))
    c2[0, 1:] = -1.0
    c2[1, :-1] = -1.0
    Aj, At = _banded_pair(c2, (-1, 1), hermitian=True)
    Ap = _pad_banded(At, 6)
    assert 0 in Ap.offsets
    dense = np.zeros((n2 + 6, n2 + 6))
    dense[:n2, :n2] = np.asarray(Aj.todense())
    dense[n2:, n2:] = np.eye(6)
    np.testing.assert_allclose(Ap.todense().numpy(), dense)


# ---------------------------------------------------------------------------
# solves: banded, CSR, grid, const
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_banded_solve(pool, solver):
    Aj, At = jst.poisson_2d(8, 16), tst.poisson_2d(8, 16)
    Bj = jst.BandedOperator(Aj.coeffs, Aj.offsets, hermitian=True)
    Bt = tst.BandedOperator(At.coeffs.clone(), At.offsets, hermitian=True)
    b = _rng(2).standard_normal(128)
    res = held(port_solve(pool, solver, Bt, b, tol=1e-10, maxiter=200),
               ref_solve(solver, Bj, b, tol=1e-10, maxiter=200))
    assert res["info"][0]
    also_single(res, single(solver, Bt, b, tol=1e-10, maxiter=200))


def test_gmres_banded(pool):
    Aj, At = jst.poisson_2d(8, 8), tst.poisson_2d(8, 8)
    Bj = jst.BandedOperator(Aj.coeffs, Aj.offsets, hermitian=True)
    Bt = tst.BandedOperator(At.coeffs.clone(), At.offsets, hermitian=True)
    b = _rng(3).standard_normal(64)
    res = held(port_solve(pool, "gmres", Bt, b, tol=1e-10, maxiter=60),
               ref_solve("gmres", Bj, b, tol=1e-10, maxiter=60))
    also_single(res, single("gmres", Bt, b, tol=1e-10, maxiter=60))


def test_gmres_cgs_one_reduction_a_sweep(pool):
    """``ortho="cgs"``: the whole CGS sweep in one all_reduce (the
    ``batch_inner`` injection), flat CSR and grid paths."""
    n = 512
    A = scipy.sparse.diags([-0.5 * np.ones(n - 1), 2.0 + np.arange(n) / n, -0.6 * np.ones(n - 1)],
                           [-1, 0, 1], format="csr")
    b = np.sin(np.arange(n) * 0.1)
    res = held(port_solve(pool, "gmres", A, b, ortho="cgs", tol=1e-10, maxiter=60),
               ref_solve("gmres", A, b, ortho="cgs", tol=1e-10, maxiter=60))
    also_single(res, single("gmres", A, b, ortho="cgs", tol=1e-10, maxiter=60))
    per_step = res["collectives"]["all_reduce"] / res["info"][1]
    assert per_step < 6, per_step  # mgs would pay k + 1 a step

    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(7).standard_normal(256)
    res = held(port_solve(pool, "gmres", At, b, ortho="cgs", tol=1e-10, maxiter=80),
               ref_solve("gmres", Aj, b, ortho="cgs", tol=1e-10, maxiter=80))
    also_single(res, single("gmres", At, b, ortho="cgs", tol=1e-10, maxiter=80))


def test_csr_halo_and_gather_modes(pool):
    sp = scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(64, 64), format="csr")
    assert tpar.partition_csr(sp, RANKS)["mode"] == "halo"
    b = _rng(4).standard_normal(64)
    res = held(port_solve(pool, "cg", sp, b, tol=1e-12, maxiter=200),
               ref_solve("cg", sp, b, tol=1e-12, maxiter=200))
    also_single(res, single("cg", sp, b, tol=1e-12, maxiter=200))

    rng = _rng(5)
    Q = rng.standard_normal((64, 64))
    dense = Q @ Q.T + 64 * np.eye(64)
    dense[np.abs(dense) < 1.0] = 0.0
    sp = scipy.sparse.csr_matrix((dense + dense.T) / 2)
    assert tpar.partition_csr(sp, RANKS)["mode"] == "gather"
    b = rng.standard_normal(64)
    res = held(port_solve(pool, "cg", sp, b, tol=1e-12, maxiter=300),
               ref_solve("cg", sp, b, tol=1e-12, maxiter=300))
    assert res["collectives"]["all_gather"] > res["info"][1]  # one a matvec
    also_single(res, single("cg", sp, b, tol=1e-12, maxiter=300))


def test_multi_rhs_over_rhs_axis(pool):
    """A 2 x 2 mesh: two row slabs, each rhs shard solving its own column."""
    Aj, At = jst.poisson_2d(8, 8), tst.poisson_2d(8, 8)
    b = _rng(8).standard_normal((64, 2))
    res = held(port_solve(pool, "cg", At, b, n_rhs=2, shard_rhs=True, tol=1e-10, maxiter=200),
               ref_solve("cg", Aj, b, n_rhs=2, shard_rhs=True, tol=1e-10, maxiter=200))
    assert res["info"][2].shape[1:] == (2,)
    also_single(res, single("cg", At, b, tol=1e-10, maxiter=200))


@pytest.mark.parametrize("shape", ["flat", "grid"])
def test_grid_path_cg_and_gmres(pool, shape):
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(11).standard_normal(256)
    if shape == "grid":
        b = b.reshape(16, 16)
    for solver, maxiter in (("cg", 300), ("gmres", 120)):
        res = held(port_solve(pool, solver, At, b, tol=1e-10, maxiter=maxiter),
                   ref_solve(solver, Aj, b, tol=1e-10, maxiter=maxiter))
        assert res["x"].shape == b.shape  # flat in, flat out; grid in, grid out
        also_single(res, single(solver, At, b, tol=1e-10, maxiter=maxiter))


def test_jacobi_preconditioned_banded_and_grid(pool):
    rng = _rng(13)
    n = 128
    d = 1.0 + 10.0 * rng.random(n)
    coeffs = np.zeros((3, n))
    coeffs[1] = d
    coeffs[0, 1:] = -0.4
    coeffs[2, : n - 1] = -0.4
    Aj, At = _banded_pair(coeffs, (-1, 0, 1), hermitian=True)
    b = rng.standard_normal(n)
    res = held(port_solve(pool, "cg", At, b, M_diag=1.0 / d, tol=1e-10, maxiter=300),
               ref_solve("cg", Aj, b, M_diag=1.0 / d, tol=1e-10, maxiter=300))
    also_single(res, single("cg", At, b, M=kt.DiagonalOperator(torch.as_tensor(1.0 / d)),
                            tol=1e-10, maxiter=300))

    Aj, At = jst.diffusion_2d(np.exp(_rng(14).standard_normal((16, 16)))), \
        tst.diffusion_2d(np.exp(_rng(14).standard_normal((16, 16))))
    b = _rng(15).standard_normal(256)
    Md = 1.0 / np.asarray(Aj.diagonal())
    res = held(port_solve(pool, "cg", At, b, M_diag=Md, tol=1e-10, maxiter=300),
               ref_solve("cg", Aj, b, M_diag=Md, tol=1e-10, maxiter=300))
    also_single(res, single("cg", At, b, M=kt.DiagonalOperator(torch.as_tensor(Md)),
                            tol=1e-10, maxiter=300))


def test_grid_multi_rhs(pool):
    """Blocked right-hand sides on the grid path: K1's batched form on the
    slab, columns held one for one; grid-shaped blocks with Jacobi."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    B = _rng(50).standard_normal((256, 3))
    res = held(port_solve(pool, "cg", At, B, tol=1e-10, maxiter=300),
               ref_solve("cg", Aj, B, tol=1e-10, maxiter=300))
    assert res["x"].shape == (256, 3) and res["info"][2].shape[1:] == (3,)
    also_single(res, single("cg", At, B, tol=1e-10, maxiter=300))

    B3 = _rng(51).standard_normal((16, 16, 2))
    Md = 1.0 / np.asarray(Aj.diagonal())
    res = held(port_solve(pool, "cg", At, B3, M_diag=Md, tol=1e-10, maxiter=300),
               ref_solve("cg", Aj, B3, M_diag=Md, tol=1e-10, maxiter=300))
    assert res["x"].shape == (16, 16, 2)


@pytest.mark.parametrize("dims", [(16, 16), (8, 4, 16)])
def test_const_stencil_solve(pool, dims):
    """K2 with each slab's first global row and both halos, 2-D and 3-D."""
    if len(dims) == 2:
        Aj, At = (jst.poisson_2d_const(*dims, dtype=np.float64),
                  tst.poisson_2d_const(*dims, dtype=np.float64))
    else:
        Aj, At = (jst.poisson_3d_const(*dims, dtype=np.float64),
                  tst.poisson_3d_const(*dims, dtype=np.float64))
    n = int(np.prod(dims))
    b = _rng(31).standard_normal(n)
    res = held(port_solve(pool, "cg", At, b, tol=1e-10, maxiter=600),
               ref_solve("cg", Aj, b, tol=1e-10, maxiter=600))
    also_single(res, single("cg", At, b, tol=1e-10, maxiter=600))


def test_gmres_restarted(pool):
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(32).standard_normal(256)
    res = held(port_solve(pool, "gmres", At, b, restart=20, tol=1e-8, maxiter=400),
               ref_solve("gmres", Aj, b, restart=20, tol=1e-8, maxiter=400))
    assert res["info"][1] > 20 and res["info"][2].shape == (res["info"][1] + 1,)
    also_single(res, single("gmres", At, b, restart=20, tol=1e-8, maxiter=400))


def test_chebyshev_and_jacobi_solvers(pool):
    Aj, At = jst.poisson_2d(8, 16), tst.poisson_2d(8, 16)
    b = _rng(33).standard_normal(128)
    kw = dict(eigenvalue_estimates=(0.05, 7.95), tol=1e-6, maxiter=2000)
    res = held(port_solve(pool, "chebyshev", At, b, **kw), ref_solve("chebyshev", Aj, b, **kw))
    also_single(res, single("chebyshev", At, b, **kw))
    kw = dict(omega=0.9, tol=1e-6, maxiter=3000)
    res = held(port_solve(pool, "jacobi", At, b, **kw), ref_solve("jacobi", Aj, b, **kw))
    assert res["info"][0]
    also_single(res, single("jacobi", At, b, **kw))


def test_gauss_seidel_hybrid_smoother(pool):
    """Slab-local sweeps, block Jacobi between ranks: the reference's
    hybrid smoother, a different trajectory from the exact sweep."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(40).standard_normal(256)
    res = held(port_solve(pool, "gauss_seidel", At, b, tol=1e-6, maxiter=5000),
               ref_solve("gauss_seidel", Aj, b, tol=1e-6, maxiter=5000))
    assert res["info"][0]


# ---------------------------------------------------------------------------
# BSR and PET
# ---------------------------------------------------------------------------


def _block_dense(n=512, R=32):
    rng = _rng(60)
    nb = n // R
    dense = np.zeros((n, n))
    for i in range(nb):
        blk = rng.standard_normal((R, R))
        dense[i*R:(i+1)*R, i*R:(i+1)*R] = blk @ blk.T + (R + 2) * np.eye(R)
        j = int(rng.integers(0, nb))
        c = 0.05 * rng.standard_normal((R, R))
        dense[i*R:(i+1)*R, j*R:(j+1)*R] += c
        dense[j*R:(j+1)*R, i*R:(i+1)*R] += c.T
    return dense, rng


def test_bsr_solve(pool):
    dense, rng = _block_dense()
    sp = scipy.sparse.csr_matrix(dense)
    Aj = jbsr.BSROperator.from_scipy(sp, blocksize=(32, 32))
    At = tbsr.BSROperator.from_scipy(sp, blocksize=(32, 32))
    b = rng.standard_normal(512)
    res = held(port_solve(pool, "cg", At, b, tol=1e-10, maxiter=400),
               ref_solve("cg", Aj, b, tol=1e-10, maxiter=400))
    also_single(res, single("cg", At, b, tol=1e-10, maxiter=400))


def _pet_matrix(n=1024, seed=70):
    rng = _rng(seed)
    rows = np.repeat(np.arange(1, n), 3)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix((0.2 * rng.standard_normal(rows.shape[0]), (rows, cols)),
                                shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()
    return A.astype(np.float32), rng


def test_pet_solve_and_rmatvec(pool):
    """K10 on the all-gathered x, its adjoint on the column slab; float32
    values, held to the reference's f32 band."""
    A, rng = _pet_matrix()
    part_t = tpar.partition_pet(A, RANKS)
    b = rng.standard_normal(1024).astype(np.float32)
    res = held(port_solve(pool, "cg", part_t, b, tol=1e-4, maxiter=200),
               ref_solve("cg", jpar.partition_pet(A, RANKS), b, tol=1e-4, maxiter=200),
               rtol=F32_RTOL, x_rtol=F32_RTOL)
    also_single(res, single("cg", kt.ops.PETOperator.from_scipy(A), b, tol=1e-4, maxiter=200),
                rtol=F32_RTOL)
    x = rng.standard_normal(1024).astype(np.float32)
    got = pool.run(_spawn.apply_job, part_t, x, adjoint=True)["x"]
    np.testing.assert_allclose(got, A.T.conj() @ x, atol=2e-4)


def test_pet_multi_rhs_and_prime_n(pool):
    """A blocked b through K11; a prime row count padded with unit rows."""
    rng = _rng(71)
    sp = scipy.sparse.diags([-1.0, 3.1, -1.0], [-1, 0, 1], shape=(512, 512),
                            format="csr").astype(np.float32)
    B = rng.standard_normal((512, 3)).astype(np.float32)
    res = held(port_solve(pool, "cg", tpar.partition_pet(sp, RANKS), B, tol=1e-4, maxiter=300),
               ref_solve("cg", jpar.partition_pet(sp, RANKS), B, tol=1e-4, maxiter=300),
               rtol=F32_RTOL, x_rtol=F32_RTOL)

    sp = scipy.sparse.diags([-1.0, 3.3, -1.0], [-1, 0, 1], shape=(509, 509),
                            format="csr").astype(np.float32)
    part = tpar.partition_pet(sp, RANKS)
    assert part["shape"][0] % RANKS == 0
    b = rng.standard_normal(509).astype(np.float32)
    res = held(port_solve(pool, "cg", part, b, tol=1e-4, maxiter=300),
               ref_solve("cg", jpar.partition_pet(sp, RANKS), b, tol=1e-4, maxiter=300),
               rtol=F32_RTOL, x_rtol=F32_RTOL)
    assert res["x"].shape == (509,)


def test_pet_rcm_reorder_matches_user_order(pool):
    """partition_pet(reorder="rcm") solves in the reordered order and
    returns the iterate in user order, step for step with the unreordered
    solve; Jacobi's M_diag is given in user order."""
    rng = _rng(113)
    n = 4096
    base = scipy.sparse.diags([-1.0, -0.5, 3.6, -0.5, -1.0], [-64, -1, 0, 1, 64],
                              shape=(n, n), format="csr")
    base = base + scipy.sparse.diags(0.3 * rng.random(n))
    p = rng.permutation(n)
    sp = base[p][:, p].tocsr().astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    part0, part1 = tpar.partition_pet(sp, RANKS), tpar.partition_pet(sp, RANKS, reorder="rcm")
    assert part1["perm"] is not None
    res0 = port_solve(pool, "cg", part0, b, tol=1e-4, maxiter=300)
    res1 = held(port_solve(pool, "cg", part1, b, tol=1e-4, maxiter=300), res0,
                rtol=F32_RTOL, x_rtol=F32_RTOL)
    held(res1, ref_solve("cg", jpar.partition_pet(sp, RANKS, reorder="rcm"), b, tol=1e-4,
                         maxiter=300), rtol=F32_RTOL, x_rtol=F32_RTOL)
    Md = 1.0 / sp.diagonal()
    resm = held(port_solve(pool, "cg", part1, b, M_diag=Md, tol=1e-4, maxiter=300),
                ref_solve("cg", jpar.partition_pet(sp, RANKS, reorder="rcm"), b, M_diag=Md,
                          tol=1e-4, maxiter=300), rtol=F32_RTOL, x_rtol=F32_RTOL)
    r = b - sp @ resm["x"]
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(b))


def test_bicgstab_over_pet(pool):
    rng = _rng(97)
    sp = _spd_csr(512, rng, density=0.01).astype(np.float32)
    b = rng.standard_normal(512).astype(np.float32)
    held(port_solve(pool, "bicgstab", tpar.partition_pet(sp, RANKS), b, tol=1e-4, maxiter=300),
         ref_solve("bicgstab", jpar.partition_pet(sp, RANKS), b, tol=1e-4, maxiter=300),
         rtol=F32_RTOL, x_rtol=F32_RTOL, steps=1)


# ---------------------------------------------------------------------------
# preconditioners through M_factory, padding, two-sided solvers
# ---------------------------------------------------------------------------


@functools.cache
def _spectrum16():
    return tuple(float(v) for v in krylov_tpu.utils.estimate_spectrum(jst.poisson_2d(16, 16),
                                                                      iters=40))


def test_chebyshev_preconditioner_through_m_factory(pool):
    """A degree-6 polynomial built on the slab operator: its matvecs are
    the slab's halo-exchanging ones and it needs no reduction."""
    lo, hi = _spectrum16()
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(80).standard_normal(256)
    res = held(
        port_solve(pool, "cg", At, b, tol=1e-9, maxiter=300,
                   M_factory=functools.partial(kt.ChebyshevPreconditioner, interval=(lo, hi),
                                               degree=6)),
        ref_solve("cg", Aj, b, tol=1e-9, maxiter=300,
                  M_factory=lambda A_l: krylov_tpu.ChebyshevPreconditioner(A_l, (lo, hi),
                                                                           degree=6)),
    )
    unprec = port_solve(pool, "cg", At, b, tol=1e-9, maxiter=300).result()
    assert res["info"][1] * 2 < unprec["info"][1]


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_ssor_smoother_through_m_factory(pool, solver):
    """SSOR sweeps on the slab (block Jacobi between ranks) as ``M`` of
    cg and the left preconditioner of bicgstab."""
    shape = (32, 32) if solver == "cg" else (32, 16)
    Aj, At = jst.poisson_2d(*shape), tst.poisson_2d(*shape)
    b = _rng(98).standard_normal(shape[0] * shape[1])
    res = held(port_solve(pool, solver, At, b, M_factory=kt.SSORSmoother, tol=1e-9, maxiter=400),
               ref_solve(solver, Aj, b, M_factory=lambda A_l: krylov_tpu.SSORSmoother(A_l),
                         tol=1e-9, maxiter=400))
    unprec = port_solve(pool, solver, At, b, tol=1e-9, maxiter=400).result()
    assert res["info"][1] < unprec["info"][1]


def test_prime_sizes_pad_to_the_shards(pool):
    """Prime row counts: unit-diagonal CSR and banded rows, unit-centre
    grid rows, masked const rows, identity BSR blocks."""
    rng = _rng(90)
    n = 509
    sp = scipy.sparse.diags([-1.0, 3.2, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    sp = (sp + scipy.sparse.diags(0.5 * rng.random(n))).tocsr()
    b = rng.standard_normal(n)
    res = held(port_solve(pool, "cg", sp, b, tol=1e-10, maxiter=400),
               ref_solve("cg", sp, b, tol=1e-10, maxiter=400))
    assert res["x"].shape == (n,)
    also_single(res, single("cg", sp, b, tol=1e-10, maxiter=400))
    B = rng.standard_normal((n, 2))
    Md = 1.0 / sp.diagonal()
    held(port_solve(pool, "cg", sp, B, M_diag=Md, tol=1e-10, maxiter=400),
         ref_solve("cg", sp, B, M_diag=Md, tol=1e-10, maxiter=400))

    coeffs = np.zeros((3, n))
    coeffs[0, 1:] = -1.0
    coeffs[1] = 3.2 + 0.5 * rng.random(n)
    coeffs[2, :-1] = -1.0
    Aj, At = _banded_pair(coeffs, (-1, 0, 1), hermitian=False)
    held(port_solve(pool, "cg", At, b, tol=1e-10, maxiter=400),
         ref_solve("cg", Aj, b, tol=1e-10, maxiter=400))

    Aj, At = jst.poisson_2d(67, 16), tst.poisson_2d(67, 16)
    b = rng.standard_normal(67 * 16)
    res = held(port_solve(pool, "cg", At, b, tol=1e-10, maxiter=600),
               ref_solve("cg", Aj, b, tol=1e-10, maxiter=600))
    also_single(res, single("cg", At, b, tol=1e-10, maxiter=600))
    Aj, At = (jst.poisson_2d_const(67, 16, dtype=np.float64),
              tst.poisson_2d_const(67, 16, dtype=np.float64))
    bc = rng.standard_normal((67, 16))
    res = held(port_solve(pool, "cg", At, bc, tol=1e-10, maxiter=600),
               ref_solve("cg", Aj, bc, tol=1e-10, maxiter=600))
    assert res["x"].shape == (67, 16)

    nb, R = 61, 3
    blocks = scipy.sparse.diags([-1.0, 2.6, -1.0], [-1, 0, 1], shape=(nb, nb), format="csr")
    dense = scipy.sparse.kron(blocks, np.eye(R) + 0.1 * rng.random((R, R))).tocsr()
    dense = (dense + dense.T).tocsr()
    Aj = jbsr.BSROperator.from_scipy(dense, blocksize=(R, R))
    At = tbsr.BSROperator.from_scipy(dense, blocksize=(R, R))
    b = rng.standard_normal(nb * R)
    held(port_solve(pool, "cg", At, b, tol=1e-10, maxiter=400),
         ref_solve("cg", Aj, b, tol=1e-10, maxiter=400))
    B = rng.standard_normal((nb * R, 2))
    held(port_solve(pool, "cg", At, B, tol=1e-10, maxiter=400),
         ref_solve("cg", Aj, B, tol=1e-10, maxiter=400))


def test_padded_rows_unit_diagonal_no_nan(pool):
    """Padded rows carry a unit diagonal: diagonal-dividing solvers and
    smoothers see 1, not 0/0, at them."""
    rng = _rng(101)
    Aj, At = jst.poisson_2d(67, 16), tst.poisson_2d(67, 16)
    b = rng.standard_normal(67 * 16)
    res = held(port_solve(pool, "cg", At, b, M_factory=kt.SSORSmoother, tol=1e-10, maxiter=600),
               ref_solve("cg", Aj, b, M_factory=lambda A_l: krylov_tpu.SSORSmoother(A_l),
                         tol=1e-10, maxiter=600))
    assert np.isfinite(res["x"]).all()
    res = held(port_solve(pool, "jacobi", At, b, omega=0.9, tol=1e-6, maxiter=4000),
               ref_solve("jacobi", Aj, b, omega=0.9, tol=1e-6, maxiter=4000))
    assert np.isfinite(res["x"]).all()
    sp = scipy.sparse.diags([-1.0, 3.2, -1.0], [-1, 0, 1], shape=(509, 509), format="csr")
    bj = rng.standard_normal(509)
    res = held(port_solve(pool, "jacobi", sp, bj, tol=1e-8, maxiter=500),
               ref_solve("jacobi", sp, bj, tol=1e-8, maxiter=500))
    assert np.isfinite(res["x"]).all()


def _spd_csr(n, rng, density=0.004):
    sp = scipy.sparse.random(n, n, density=density, random_state=42, format="csr")
    sp = sp + sp.T
    sp.setdiag(4.0 + rng.random(n))
    sp.sum_duplicates()
    return sp.tocsr()


@pytest.mark.parametrize("solver", ["bicgstab", "qmr"])
def test_two_sided_with_jacobi(pool, solver):
    """BiCGSTAB and QMR (its adjoint halo path) with a Jacobi left
    preconditioner over row-partitioned CSR."""
    rng = _rng(95 if solver == "bicgstab" else 96)
    n = 512
    sp = _spd_csr(n, rng)
    off = (1, 0.3) if solver == "bicgstab" else (-1, 0.2)
    sp = (sp + scipy.sparse.diags(off[1] * rng.random(n - 1), off[0])).tocsr()
    b = rng.standard_normal(n)
    Md = 1.0 / sp.diagonal()
    res = held(port_solve(pool, solver, sp, b, M_diag=Md, tol=1e-9, maxiter=300),
               ref_solve(solver, sp, b, M_diag=Md, tol=1e-9, maxiter=300))
    also_single(res, single(solver, sp, b, Ml=kt.DiagonalOperator(torch.as_tensor(Md)),
                            tol=1e-9, maxiter=300))


def test_csr_reorder_flips_gather_to_halo(pool):
    rng = _rng(117)
    n = 1024
    base = scipy.sparse.diags([-1.0, 3.1, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    base = base + scipy.sparse.diags(0.2 * rng.random(n))
    p = rng.permutation(n)
    sp = base[p][:, p].tocsr()
    b = rng.standard_normal(n)
    assert tpar.partition_csr(sp, RANKS)["mode"] == "gather"
    perm = kt.ops.cuda_spmv.rcm_permutation(sp)
    assert tpar.partition_csr(sp[perm][:, perm].tocsr(), RANKS)["mode"] == "halo"
    res0 = port_solve(pool, "cg", sp, b, tol=1e-10, maxiter=200)
    res1 = held(port_solve(pool, "cg", sp, b, tol=1e-10, maxiter=200, reorder="auto"),
                ref_solve("cg", sp, b, tol=1e-10, maxiter=200, reorder="auto"))
    held(res1, res0, rtol=1e-8)
    # halo mode after the reordering: the one gather is the iterate's at the end
    assert res1["collectives"]["all_gather"] == 1
    held(port_solve(pool, "gmres", sp, b, tol=1e-8, maxiter=120, restart=30, reorder="rcm"),
         ref_solve("gmres", sp, b, tol=1e-8, maxiter=120, restart=30, reorder="rcm"))


def test_complex_solves(pool):
    """A complex HPD system through cg, a non-Hermitian one through gmres
    and bicgstab: conjugated reduced inners, complex halos."""
    n = 64
    T = scipy.sparse.diags([(-1 + 0.4j) * np.ones(n - 1), 3.0 * np.ones(n),
                            (-1 - 0.4j) * np.ones(n - 1)], [-1, 0, 1], format="csr")
    rng = _rng(9)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    res = held(port_solve(pool, "cg", T, b, tol=1e-12, maxiter=200),
               ref_solve("cg", T, b, tol=1e-12, maxiter=200))
    also_single(res, single("cg", T, b, tol=1e-12, maxiter=200))
    T = scipy.sparse.diags([(-1 + 0.7j) * np.ones(n - 1), (3.0 + 0.3j) * np.ones(n),
                            (-0.5 - 0.2j) * np.ones(n - 1)], [-1, 0, 1], format="csr")
    b = _rng(10).standard_normal(n) + 1j * _rng(11).standard_normal(n)
    for solver in ("gmres", "bicgstab"):
        held(port_solve(pool, solver, T, b, tol=1e-10, maxiter=200),
             ref_solve(solver, T, b, tol=1e-10, maxiter=200))


# ---------------------------------------------------------------------------
# monitors, build-once solvers, the injected reductions
# ---------------------------------------------------------------------------


def _calls(res):
    """The monitor's calls on each rank: all on rank 0 of the rows axis."""
    counts = [len(p["calls"]) for p in res["per_rank"]]
    assert counts[1:] == [0] * (len(counts) - 1), counts
    return sorted(res["per_rank"][0]["calls"], key=lambda c: c[0])


def test_callback_monitor_grid_and_csr_paths(pool):
    """``callback(k, resnorm)`` fires numsteps + 1 times, on rank 0 only,
    with the recurrence values (the explicit recheck may overwrite the
    last history entry), as the reference's monitor."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = _rng(0).standard_normal(256)
    res = held(port_solve(pool, "cg", At, b, tol=1e-8, maxiter=300, record=True),
               ref_solve("cg", Aj, b, tol=1e-8, maxiter=300))
    calls = _calls(res)
    steps = res["info"][1]
    assert [k for k, _ in calls] == list(range(steps + 1))
    rn = np.array([float(r) for _, r in calls])
    hist = res["info"][2]
    np.testing.assert_array_equal(rn[:-1], hist[:-1])
    assert rn[-1] <= hist[0]

    ref_calls = []
    jpar.sharded_solve(krylov_tpu.cg, Aj, jnp.asarray(b), mesh=_jmesh(), tol=1e-8, maxiter=300,
                       callback=lambda k, r: ref_calls.append((int(k), float(r))))
    ref_calls.sort()
    np.testing.assert_allclose(rn, [r for _, r in ref_calls], rtol=1e-9)

    N = 256
    sp = scipy.sparse.diags([-1.0, 3.0, -1.0], [-1, 0, 1], shape=(N, N), format="csr")
    b = _rng(1).standard_normal(N)
    res = held(port_solve(pool, "bicgstab", sp, b, M_diag=1.0 / sp.diagonal(), tol=1e-9,
                          maxiter=300, record=True),
               ref_solve("bicgstab", sp, b, M_diag=1.0 / sp.diagonal(), tol=1e-9, maxiter=300))
    assert [k for k, _ in _calls(res)] == list(range(res["info"][1] + 1))


def test_make_sharded_solver_matches_sharded_solve(pool):
    """Build once, solve many: the same trajectories bit for bit, on the
    grid route (two right-hand sides, then a blocked one) and the CSR route
    (prime N, Jacobi)."""
    At = tst.poisson_2d(32, 32)
    bs = [_rng(s).standard_normal(1024) for s in (1, 2)]
    built = pool.run(_spawn.solver_job, kt.cg, At, bs, tol=1e-10, maxiter=300)
    for j, b in enumerate(bs):
        fresh = port_solve(pool, "cg", At, b, tol=1e-10, maxiter=300).result()
        assert built["info"][j][1] == fresh["info"][1]
        np.testing.assert_array_equal(built["info"][j][2], fresh["info"][2])
        np.testing.assert_array_equal(built["x"][j], fresh["x"])
    B = _rng(3).standard_normal((1024, 2))
    built = pool.run(_spawn.solver_job, kt.cg, At, [B], tol=1e-10, maxiter=300, n_rhs=2)
    fresh = port_solve(pool, "cg", At, B, tol=1e-10, maxiter=300).result()
    np.testing.assert_array_equal(built["info"][0][2], fresh["info"][2])

    N = 509
    sp = scipy.sparse.diags([-1.0, 3.0, -1.0], [-1, 0, 1], shape=(N, N), format="csr")
    dinv = 1.0 / sp.diagonal()
    b = _rng(0).standard_normal(N)
    built = pool.run(_spawn.solver_job, kt.bicgstab, sp, [b], M_diag=dinv, tol=1e-9,
                     maxiter=300)
    fresh = port_solve(pool, "bicgstab", sp, b, M_diag=dinv, tol=1e-9, maxiter=300).result()
    assert built["info"][0][1] == fresh["info"][1]
    np.testing.assert_array_equal(built["info"][0][2], fresh["info"][2])
    held(fresh, ref_solve("bicgstab", sp, b, M_diag=dinv, tol=1e-9, maxiter=300))


def test_make_sharded_solver_refuses_what_it_cannot_take():
    mesh = tpar.make_mesh(device="cpu")  # a world of one in this process
    A = tst.poisson_2d(8, 8)
    run = tpar.make_sharded_solver(kt.cg, A, mesh=mesh, tol=1e-10, maxiter=100)
    with pytest.raises(ValueError):
        run(torch.zeros(64, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tpar.make_sharded_solver(kt.gmres, A, mesh=mesh, restart=10)
    # a grid operator takes multigrid_factory, not a partition; a partition
    # built for another rows axis refuses, in both entry points
    sp = scipy.sparse.diags([-1.0, 3.0, -1.0], [-1, 0, 1], shape=(64, 64), format="csr")
    with pytest.raises(TypeError, match="multigrid_factory"):
        tpar.sharded_solve(kt.cg, A, np.ones(64), mesh=mesh,
                           M_partition=tpar.partition_block_jacobi(sp, 1, block=8))
    with pytest.raises(TypeError, match="multigrid_factory"):
        tpar.make_sharded_solver(kt.cg, A, mesh=mesh,
                                 M_partition=tpar.partition_block_jacobi(sp, 1, block=8))
    with pytest.raises(ValueError, match="shards"):
        tpar.make_sharded_solver(kt.cg, sp, mesh=mesh,
                                 M_partition=tpar.partition_block_jacobi(sp, 2, block=8))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpar.make_sharded_solver(kt.cg, sp, mesh=mesh, M_diag=np.ones(64),
                                 M_partition=tpar.partition_block_jacobi(sp, 1, block=8))


@pytest.mark.parametrize("solver,b_shape", [
    ("cg_block", (128, 3)), ("cg_pipelined", (128,)), ("cg_pipelined", (128, 2)),
])
def test_block_and_pipelined_reductions(pool, solver, b_shape):
    """The injected ``block_inner`` (one all_reduce a (k, k) Gram block)
    and ``fused_inner`` (one all_reduce for all of a pipelined step's
    scalars, per column for a blocked b)."""
    Aj, At = jst.poisson_2d(8, 16), tst.poisson_2d(8, 16)
    b = _rng(3 if solver == "cg_block" else 7).standard_normal(b_shape)
    res = held(port_solve(pool, solver, At, b, tol=1e-8, maxiter=300),
               ref_solve(solver, Aj, b, tol=1e-8, maxiter=300))
    also_single(res, single(solver, At, b, tol=1e-8, maxiter=300))


def test_tfqmr_sharded(pool):
    n_side = 48
    n = n_side * n_side
    A = scipy.sparse.diags([-1.0, -1.0, 4.2, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
                           shape=(n, n), format="csr")
    b = _rng(0).standard_normal(n)
    res = held(port_solve(pool, "tfqmr", A, b, tol=1e-9, maxiter=600),
               ref_solve("tfqmr", A, b, tol=1e-9, maxiter=600))
    also_single(res, single("tfqmr", A, b, tol=1e-9, maxiter=600))
