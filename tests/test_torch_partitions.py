"""krylov_tpu_torch's M_partition preconditioners held to krylov_tpu's.

The host-built partitions (``partition_amg``, ``partition_ilu0``,
``partition_block_jacobi``) against the reference's: their set-up arrays
exactly in float64, their single-device twins (``as_global()``) applied to a
seeded vector to rtol 1e-10, each rank's ``make_local`` applied and gathered
against the port's twin, and the sharded solves of the reference's own tests
(``tests/test_parallel_amg.py``, ``tests/test_schwarz.py``, the partition
cases of ``tests/test_blockjacobi.py``) on four gloo ranks: held to the
reference's sharded solve on a four-device mesh (float64, equal numsteps,
resnorms within rtol 1e-9; each reference solve computed once) and to the
port's single-device twin on the padded problem.  Every refusal of the
reference is checked.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ilu import _ilu0_factor
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.parallel import _spawn
from krylov_tpu_torch.parallel.csr import pad_unit_diagonal
from tests.test_torch_parallel import F32_RTOL, RANKS, held, pool  # noqa: F401

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


def _poisson2d(n, dtype=np.float64):
    I = scipy.sparse.identity(n, dtype=dtype)
    T = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), dtype=dtype)
    return (scipy.sparse.kron(I, T) + scipy.sparse.kron(T, I)).tocsr()


def _convection_diffusion(n=31, pe=20.0):
    h = 1.0 / (n + 1)
    T = scipy.sparse.diags([-1 - pe * h / 2, 2.0, -1 + pe * h / 2], [-1, 0, 1], shape=(n, n))
    I = scipy.sparse.identity(n)
    return (scipy.sparse.kron(I, T) + scipy.sparse.kron(T, I)).tocsr()


def _aniso(n, eps=100.0):
    I = scipy.sparse.identity(n, dtype=np.float64)
    T = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), dtype=np.float64)
    return (scipy.sparse.kron(I, eps * T) + scipy.sparse.kron(T, I)).tocsr()


# 31 * 31 = 961 rows: prime to 4, so the fine level pads to 964
A = _poisson2d(31)
N = A.shape[0]
B1 = np.random.default_rng(7).standard_normal(N)
BK = np.random.default_rng(8).standard_normal((N, 3))
BK4 = np.random.default_rng(9).standard_normal((N, 4))
C = _convection_diffusion()
BC = np.random.default_rng(5).standard_normal(N)
# 33 * 33 = 1089 rows pad to 1092: 273 rows a rank, blocks of 21
A_BJ = _aniso(33)
B_BJ = np.random.default_rng(3).standard_normal(A_BJ.shape[0])
D = scipy.sparse.diags(np.linspace(1.0, 3.0, N)).tocsr()

AMG_KW = {
    "default": {},
    "two_levels_chebyshev": dict(n_sharded_levels=2, coarse_size=60, smoother="chebyshev"),
}


def _padded(M, b):
    pad = (-M.shape[0]) % RANKS
    return pad_unit_diagonal(M, pad), np.concatenate([b, np.zeros((pad,) + b.shape[1:])])


@functools.cache
def ref_solve(case):
    """The reference's sharded solve of a case, once."""
    solver, Mat, b, n_rhs, kw = CASES[case]()
    kw = dict(kw)
    if "M_partition" in kw:
        build, args, pkw = kw["M_partition"]
        kw["M_partition"] = getattr(jpar, build)(*args, **pkw)
    mesh = jpar.make_mesh(n_rows=RANKS // n_rhs, n_rhs=n_rhs)
    _, info = jpar.sharded_solve(getattr(krylov_tpu, solver), Mat, jnp.asarray(b), mesh=mesh,
                                 **kw)
    return info


def port_solve(pool, case):  # noqa: F811
    solver, Mat, b, n_rhs, kw = CASES[case]()
    kw = dict(kw)
    if "M_partition" in kw:
        build, args, pkw = kw["M_partition"]
        kw["M_partition"] = getattr(tpar, build)(*args, **pkw)
    return pool.submit(_spawn.solve_job, getattr(kt, solver), Mat, b, mesh_rows=RANKS // n_rhs,
                       mesh_rhs=n_rhs, **kw)


def _amg(**kw):
    return ("partition_amg", (A, RANKS), kw)


CASES = {
    "amg_cg": lambda: ("cg", A, B1, 1, dict(tol=1e-9, M_partition=_amg())),
    "amg2_cheb_multirhs": lambda: ("cg", A, BK, 1, dict(
        tol=1e-9, M_partition=_amg(**AMG_KW["two_levels_chebyshev"]))),
    "amg_bicgstab": lambda: ("bicgstab", A, B1, 1, dict(tol=1e-9, M_partition=_amg())),
    "amg_stalled": lambda: ("cg", D, B1, 1, dict(
        tol=1e-10, M_partition=("partition_amg", (D, RANKS), {}))),
    "amg_rhs_axis": lambda: ("cg", A, BK4, 2, dict(
        tol=1e-9, shard_rhs=True, M_partition=("partition_amg", (A, RANKS // 2), {}))),
    "ilu_bicgstab": lambda: ("bicgstab", C, BC, 1, dict(
        tol=1e-8, maxiter=200, M_partition=("partition_ilu0", (C, RANKS), {}))),
    "bicgstab_plain": lambda: ("bicgstab", C, BC, 1, dict(tol=1e-8, maxiter=2 * N)),
    "ilu_qmr": lambda: ("qmr", C, BC, 1, dict(
        tol=1e-8, maxiter=200,
        M_partition=("partition_ilu0", (C, RANKS), dict(with_rmatvec=True)))),
    "ilu_gmres_multirhs": lambda: ("gmres", C, BK[:, :2], 1, dict(
        tol=1e-8, maxiter=100,
        M_partition=("partition_ilu0", (C, RANKS), dict(with_rmatvec=True)))),
    "ilu_cg_spd": lambda: ("cg", A, B1, 1, dict(
        tol=1e-8, maxiter=500, M_partition=("partition_ilu0", (A, RANKS), {}))),
    "cg_plain": lambda: ("cg", A, B1, 1, dict(tol=1e-8, maxiter=2000)),
    "bj_cg": lambda: ("cg", A_BJ, B_BJ, 1, dict(
        tol=1e-8, M_partition=("partition_block_jacobi", (A_BJ, RANKS), dict(block=21)))),
}


def _twin(solver, Mat, b, part, **kw):
    """The port's single-device solve on the padded problem with the
    partition's twin as its preconditioner."""
    A_pad, b_pad = _padded(Mat, b)
    slot = "M" if solver in ("cg", "minres") else "Ml"
    _, info = getattr(kt, solver)(A_pad, torch.as_tensor(b_pad), backend="while_loop",
                                  **{slot: part.as_global()}, **kw)
    return info


def _twin_held(res, info):
    """A sharded result held to its single-device twin on the padded
    problem: equal numsteps, resnorms within rtol 1e-9 (and the absolute
    floor of ``held``, 1e-12 of the first residual: the collectives reorder
    the inner products' sums)."""
    want = np.asarray(info.resnorms)
    assert res["info"][1] == info.numsteps
    np.testing.assert_allclose(res["info"][2], want, rtol=1e-9,
                               atol=1e-12 * float(np.max(np.abs(want[0]))))


# ---------------------------------------------------------------------------
# set-up arrays, exactly
# ---------------------------------------------------------------------------


def _prolongator(lv, n_shards, n_rows):
    offs = (np.arange(n_shards) * lv["n_local"])[:, None]
    return scipy.sparse.csr_matrix(
        (np.asarray(lv["p_dat"]).ravel(),
         ((np.asarray(lv["p_rowf"]) + offs).ravel(), np.asarray(lv["p_colc"]).ravel())),
        shape=(n_rows, lv["n_next"]))


@pytest.mark.parametrize("matrix,kw", [("poisson", "default"), ("poisson", "two_levels_chebyshev"),
                                       ("diagonal", "default")])
def test_amg_partition_setup_equals_reference(matrix, kw):
    M = A if matrix == "poisson" else D
    pt = tpar.partition_amg(M, RANKS, **AMG_KW[kw])
    pj = jpar.partition_amg(M, RANKS, **AMG_KW[kw])
    assert (pt.n_pad, pt.n_shards, pt.shape) == (pj.n_pad, pj.n_shards, pj.shape)
    assert pt.n_local_fine == pj.n_local_fine and pt.n_sharded_levels == pj.n_sharded_levels
    assert pt.level_sizes == pj.level_sizes
    assert pt._jw == pj._jw and pt._lmaxs == pj._lmaxs
    for i, (lt, lj) in enumerate(zip(pt._levels, pj._levels)):
        assert (lt["n_local"], lt["n_next"]) == (lj["n_local"], lj["n_next"])
        np.testing.assert_array_equal(lt["dinv"], np.asarray(lj["dinv"]))
        Pt = _prolongator(lt, RANKS, pt.padded_matrix(i).shape[0])
        Pj = _prolongator(lj, RANKS, pj.padded_matrix(i).shape[0])
        assert abs(Pt - Pj).max() == 0.0
        assert abs(pt.padded_matrix(i) - pj.padded_matrix(i)).max() == 0.0
        assert (lt["Apart"] is None) == (lj["Apart"] is None)
        if lt["Apart"] is not None:
            at, aj = lt["Apart"], lj["Apart"]
            assert (at["n_local"], at["halo"], at["mode"]) == (aj["n_local"], aj["halo"],
                                                               aj["mode"])
            for s in range(RANKS):  # the slabs (the port pads in the slab's last row)
                slab_t, slab_j = (scipy.sparse.coo_matrix(
                    (np.asarray(a["data"][s]), (np.asarray(a["row"][s]), np.asarray(a["col"][s])))
                ).tocsr() for a in (at, aj))
                assert abs(slab_t - slab_j).max() == 0.0


@pytest.mark.parametrize("with_rmatvec", [False, True])
def test_ilu0_partition_setup_equals_reference(with_rmatvec):
    pt = tpar.partition_ilu0(C, RANKS, with_rmatvec=with_rmatvec)
    pj = jpar.partition_ilu0(C, RANKS, with_rmatvec=with_rmatvec)
    assert (pt.n_pad, pt.n_local_fine, pt.nlevels) == (pj.n_pad, pj.n_local_fine, pj.nlevels)
    assert len(pt._arrays) == len(pj._arrays) == (20 if with_rmatvec else 10)
    for t, j in zip(pt._arrays, pj._arrays):
        np.testing.assert_array_equal(t, np.asarray(j))


def test_block_jacobi_partition_setup_equals_reference():
    pt = tpar.partition_block_jacobi(A_BJ, RANKS, block=21)
    pj = jpar.partition_block_jacobi(A_BJ, RANKS, block=21)
    assert (pt.n_pad, pt.n_local_fine, pt.block, pt.shape) == (
        pj.n_pad, pj.n_local_fine, pj.block, pj.shape)
    np.testing.assert_array_equal(pt._inv, np.asarray(pj._inv))


# ---------------------------------------------------------------------------
# the single-device twins and each rank's make_local
# ---------------------------------------------------------------------------


PARTITIONS = {
    "amg": lambda pkg: pkg.partition_amg(A, RANKS),
    "amg2_cheb": lambda pkg: pkg.partition_amg(A, RANKS, **AMG_KW["two_levels_chebyshev"]),
    "amg_stalled": lambda pkg: pkg.partition_amg(D, RANKS),
    "ilu0": lambda pkg: pkg.partition_ilu0(C, RANKS, with_rmatvec=True),
    "block_jacobi": lambda pkg: pkg.partition_block_jacobi(A_BJ, RANKS, block=21),
}
MATRIX = {"amg": A, "amg2_cheb": A, "amg_stalled": D, "ilu0": C, "block_jacobi": A_BJ}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_twin_applies_like_the_reference(name):
    pt, pj = PARTITIONS[name](tpar), PARTITIONS[name](jpar)
    v = np.random.default_rng(40).standard_normal(pt.n_pad)
    Mt, Mj = pt.as_global(), pj.as_global()
    want = np.asarray(Mj @ jnp.asarray(v))
    np.testing.assert_allclose((Mt @ torch.as_tensor(v)).numpy(), want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    if name == "ilu0":
        want = np.asarray(Mj.rmatvec(jnp.asarray(v)))
        np.testing.assert_allclose(Mt.rmatvec(torch.as_tensor(v)).numpy(), want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name,adjoint", [(n, False) for n in sorted(PARTITIONS)]
                         + [("ilu0", True)])
def test_make_local_on_four_ranks_equals_the_twin(pool, name, adjoint):  # noqa: F811
    """Each rank's preconditioner, applied to its slab and gathered: the
    twin's product, up to the order of the collectives' sums."""
    part = PARTITIONS[name](tpar)
    x = np.random.default_rng(41).standard_normal(part.n_pad)
    got = pool.run(_spawn.partition_apply_job, MATRIX[name], part, x, adjoint=adjoint)
    twin = part.as_global()
    want = (twin.rmatvec(torch.as_tensor(x)) if adjoint else twin @ torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got["x"], want, rtol=1e-12, atol=1e-13 * np.abs(want).max())
    assert not any(p["forbidden"] for p in got["per_rank"])


# ---------------------------------------------------------------------------
# distributed AMG (tests/test_parallel_amg.py)
# ---------------------------------------------------------------------------


def test_amg_cg_converges_fast_and_matches_direct(pool):  # noqa: F811
    job = port_solve(pool, "amg_cg")
    res = held(job, ref_solve("amg_cg"))
    assert res["info"][0] and res["info"][1] <= 20
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(A.tocsc(), B1))) < 1e-6
    assert tpar.partition_amg(A, RANKS).n_pad == N + (-N) % RANKS


def test_amg_trajectory_matches_global_twin(pool):  # noqa: F811
    """The distributed cycle is the single-device cycle: the collectives
    only reorder sums."""
    job = port_solve(pool, "amg_cg")
    _twin_held(job.result(), _twin("cg", A, B1, tpar.partition_amg(A, RANKS), tol=1e-9))


def test_amg_two_sharded_levels_chebyshev_multirhs(pool):  # noqa: F811
    """reduce_scatter / all_gather between two sharded levels, the
    Chebyshev smoother and a blocked right-hand side together."""
    job = port_solve(pool, "amg2_cheb_multirhs")
    res = held(job, ref_solve("amg2_cheb_multirhs"))
    assert res["info"][0] and res["info"][1] <= 20
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(A.tocsc(), BK))) < 1e-6
    assert all(p["collectives"]["reduce_scatter"] > 0 for p in res["per_rank"])
    part = tpar.partition_amg(A, RANKS, **AMG_KW["two_levels_chebyshev"])
    assert part.n_sharded_levels == 2
    _twin_held(res, _twin("cg", A, BK, part, tol=1e-9))


def test_amg_left_preconditions_bicgstab(pool):  # noqa: F811
    """Solvers without ``M`` take the cycle as ``Ml``."""
    job = port_solve(pool, "amg_bicgstab")
    res = held(job, ref_solve("amg_bicgstab"))
    assert res["info"][0] and res["info"][1] <= 15
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(A.tocsc(), B1))) < 1e-5


def test_amg_partition_validation():
    mesh = tpar.make_mesh(device="cpu")  # a world of one in this process
    part = tpar.partition_amg(A, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpar.sharded_solve(kt.cg, A, B1, mesh=mesh, M_partition=part, M_diag=np.ones(N))
    with pytest.raises(ValueError, match="reorder"):
        tpar.sharded_solve(kt.cg, A, B1, mesh=mesh, M_partition=part, reorder="rcm")
    with pytest.raises(ValueError, match="shards"):
        tpar.sharded_solve(kt.cg, A, B1, mesh=mesh, M_partition=tpar.partition_amg(A, RANKS))
    with pytest.raises(ValueError, match="smoother"):
        tpar.partition_amg(A, RANKS, smoother="sor")
    with pytest.raises(ValueError, match="padded size"):
        tpar.sharded_solve(kt.cg, A[:-1, :-1], B1[:-1], mesh=mesh, M_partition=part)
    with pytest.raises(ValueError, match="without reorder"):
        tpar.sharded_solve(kt.cg, tpar.partition_pet(A.astype(np.float32), 1, reorder="rcm"),
                           B1.astype(np.float32), mesh=mesh, M_partition=part)
    with pytest.raises(TypeError, match="multigrid_factory"):
        tpar.sharded_solve(kt.cg, kt.poisson_2d_const(31, 31, dtype=np.float64), B1,
                           mesh=mesh, M_partition=part)
    with pytest.raises(ValueError, match="neither M nor Ml"):
        tpar.sharded_solve(kt.lsqr, A, B1, mesh=mesh, M_partition=part)


def test_amg_over_pet_partition_fine_level(pool):  # noqa: F811
    """The fine level smooths through whatever slab the solve shards, here
    the PET route (float32; its padded rows are unit-diagonal too)."""
    A32, b32 = A.astype(np.float32), B1.astype(np.float32)
    kw = dict(tol=1e-4, M_partition=tpar.partition_amg(A32, RANKS))
    job = pool.submit(_spawn.solve_job, kt.cg, tpar.partition_pet(A32, RANKS), b32, **kw)
    _, ref = jpar.sharded_solve(krylov_tpu.cg, jpar.partition_pet(A32, RANKS), jnp.asarray(b32),
                                mesh=jpar.make_mesh(n_rows=RANKS), tol=1e-4,
                                M_partition=jpar.partition_amg(A32, RANKS))
    res = held(job, ref, rtol=F32_RTOL, steps=1)
    assert res["info"][0] and res["info"][1] <= 20
    r = b32 - A @ res["x"]
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(B1))


def test_amg_stalled_coarsening_degenerates_to_smoothing(pool):  # noqa: F811
    """A diagonal matrix has an empty strength graph: sharded Jacobi
    smoothing, which solves it outright."""
    res = held(port_solve(pool, "amg_stalled"), ref_solve("amg_stalled"))
    assert res["info"][0] and res["info"][1] <= 12
    assert np.max(np.abs(res["x"] - B1 / D.diagonal())) < 1e-8


def test_amg_with_rhs_axis_data_parallelism(pool):  # noqa: F811
    """A (rows=2, rhs=2) mesh splits the columns over the rhs axis while
    the cycle's collectives stay on rows."""
    res = held(port_solve(pool, "amg_rhs_axis"), ref_solve("amg_rhs_axis"))
    assert res["info"][0] and res["info"][1] <= 25
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(A.tocsc(), BK4))) < 1e-6


# ---------------------------------------------------------------------------
# ILU(0)-Schwarz (tests/test_schwarz.py)
# ---------------------------------------------------------------------------


def test_global_twin_matches_host_block_solves():
    part = tpar.partition_ilu0(C, RANKS, with_rmatvec=True)
    C_pad, b_pad = _padded(C, BC)
    z = (part.as_global() @ torch.as_tensor(b_pad)).numpy()
    n_loc = part.n_local_fine
    z_ref = np.empty(part.n_pad)
    for s in range(RANKS):
        r0 = s * n_loc
        L, U = _ilu0_factor(C_pad[r0 : r0 + n_loc, r0 : r0 + n_loc].tocsr())
        y = scipy.sparse.linalg.spsolve_triangular(L.tocsr(), b_pad[r0 : r0 + n_loc], lower=True)
        z_ref[r0 : r0 + n_loc] = scipy.sparse.linalg.spsolve_triangular(U.tocsr(), y,
                                                                        lower=False)
    np.testing.assert_allclose(z, z_ref, rtol=1e-12, atol=1e-14)
    rng = np.random.default_rng(5)
    u, v = rng.standard_normal(part.n_pad), rng.standard_normal(part.n_pad)
    tw = part.as_global()
    lhs = np.dot(u, (tw @ torch.as_tensor(v)).numpy())
    rhs = np.dot(tw.rmatvec(torch.as_tensor(u)).numpy(), v)
    assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))


def test_sharded_bicgstab_matches_twin_trajectory(pool):  # noqa: F811
    plain = port_solve(pool, "bicgstab_plain").result()
    job = port_solve(pool, "ilu_bicgstab")
    res = held(job, ref_solve("ilu_bicgstab"))
    assert res["info"][0] and res["info"][1] * 2 < plain["info"][1]
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(C.tocsc(), BC))) < 1e-5
    _twin_held(res, _twin("bicgstab", C, BC, tpar.partition_ilu0(C, RANKS), tol=1e-8,
                          maxiter=200))


def test_sharded_qmr_uses_adjoint_and_multirhs_gmres(pool):  # noqa: F811
    res = held(port_solve(pool, "ilu_qmr"), ref_solve("ilu_qmr"))
    assert res["info"][0]
    res = held(port_solve(pool, "ilu_gmres_multirhs"), ref_solve("ilu_gmres_multirhs"))
    assert res["info"][0]
    X = scipy.sparse.linalg.spsolve(C.tocsc(), BK[:, :2])
    assert np.max(np.abs(res["x"] - X)) < 1e-5


def test_adjoint_refused_without_flag():
    mesh = tpar.make_mesh(device="cpu")  # a world of one in this process
    with pytest.raises(ValueError, match="with_rmatvec"):
        tpar.sharded_solve(kt.qmr, C, BC, mesh=mesh, tol=1e-8, maxiter=50,
                           M_partition=tpar.partition_ilu0(C, 1))


def test_spd_ilu_schwarz_preconditions_cg(pool):  # noqa: F811
    """Per-slab ILU(0) of SPD blocks is IC(0), so the partition is a valid
    CG ``M``."""
    plain = port_solve(pool, "cg_plain").result()
    res = held(port_solve(pool, "ilu_cg_spd"), ref_solve("ilu_cg_spd"))
    assert res["info"][0] and res["info"][1] < 0.6 * plain["info"][1]
    assert np.max(np.abs(res["x"] - scipy.sparse.linalg.spsolve(A.tocsc(), B1))) < 1e-6


# ---------------------------------------------------------------------------
# block Jacobi (tests/test_blockjacobi.py)
# ---------------------------------------------------------------------------


def test_sharded_block_jacobi_matches_global_twin(pool):  # noqa: F811
    job = port_solve(pool, "bj_cg")
    res = held(job, ref_solve("bj_cg"))
    assert res["info"][0]
    _twin_held(res, _twin("cg", A_BJ, B_BJ,
                          tpar.partition_block_jacobi(A_BJ, RANKS, block=21), tol=1e-8))


def test_block_jacobi_partition_validation():
    with pytest.raises(ValueError, match="divisor"):
        tpar.partition_block_jacobi(A_BJ, RANKS, block=20)  # 273 % 20 != 0
    with pytest.raises(ValueError, match="square"):
        kt.BlockJacobiPreconditioner.from_scipy(
            scipy.sparse.random(8, 5, density=0.5, format="csr", random_state=0))


# ---------------------------------------------------------------------------
# build once, solve many
# ---------------------------------------------------------------------------


def test_make_sharded_solver_takes_a_partition(pool):  # noqa: F811
    """``make_sharded_solver(M_partition=)`` builds each rank's cycle once;
    its solves repeat ``sharded_solve``'s bit for bit."""
    part = tpar.partition_amg(A, RANKS)
    bs = [B1, BC]
    built = pool.run(_spawn.solver_job, kt.cg, A, bs, tol=1e-9, M_partition=part)
    for j, b in enumerate(bs):
        fresh = pool.run(_spawn.solve_job, kt.cg, A, b, tol=1e-9, M_partition=part)
        assert built["info"][j][1] == fresh["info"][1]
        np.testing.assert_array_equal(built["info"][j][2], fresh["info"][2])
        np.testing.assert_array_equal(built["x"][j], fresh["x"])
