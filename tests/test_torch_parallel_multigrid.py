"""krylov_tpu_torch's sharded geometric multigrid held to krylov_tpu's.

``multigrid_factory`` (couplings ``auto``, ``full``, ``local``) as the
``M_factory`` of ``sharded_solve`` on four gloo ranks, on the cases of the
reference's ``tests/test_parallel.py`` (its sharded multigrid tests): the
Galerkin cycles held to the reference's sharded solve on a four-device mesh
(float64, equal numsteps, resnorms within rtol 1e-9); the constant-stencil
cycles to the reference's own checks (the single-device V-cycle's iteration
count within 2 for ``full``, convergence and residuals for the others),
because the reference's sharded const-stencil solves compile for tens of
seconds on the CPU.  Their parts are held exactly instead: the Galerkin
coarsening on a seeded field, and the sharded order-2 transfers on four
ranks against the reference's single-device ones.  Every refusal of the
reference is checked.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import multigrid as jmg
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import multigrid as tmg
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.parallel import _spawn
from tests.test_torch_parallel import RANKS, held, pool  # noqa: F401

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


def _rng(seed):
    return np.random.default_rng(seed)


def _smooth_field(nx, ny):
    X, Y = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    return 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)


def _padded_field():
    return 1.0 + 0.5 * np.abs(np.sin(3 * np.linspace(0, 1, 67)))[:, None] * np.ones(32)


def _residual(A, x, b):
    """``|b - A x| / (1 + |b|)`` on the port's operator, in float64."""
    b = torch.as_tensor(b)
    r = b - A @ torch.as_tensor(x).reshape(b.shape)
    return float(torch.linalg.norm(r) / (1 + torch.linalg.norm(b)))


@functools.cache
def _reference_single_mg_steps():
    """The reference's single-device MG-CG on the 128^2 Poisson of the
    ``full`` case (its own comparison)."""
    A = jst.poisson_2d_const(128, 128, dtype=np.float64)
    b = jnp.asarray(_rng(91).standard_normal((128, 128)))
    _, info = krylov_tpu.cg(A, b, M=krylov_tpu.MultigridPreconditioner(A),
                            inner=lambda u, v: jnp.sum(u * v), tol=1e-8, maxiter=200)
    return int(info.numsteps)


# ---------------------------------------------------------------------------
# parts, exactly
# ---------------------------------------------------------------------------


def test_galerkin_coarsening_equals_reference():
    """Parity sub-sampling of a seeded 64 x 16 lognormal field's planes,
    on numpy and on tensors, twice down."""
    a = np.exp(_rng(11).standard_normal((64, 16)))
    At, Aj = tst.diffusion_2d(a), jst.diffusion_2d(a)
    ct, ro, co = At.coeffs2d, At.row_offsets, At.col_offsets
    cj, rj, coj = np.asarray(Aj.coeffs2d), tuple(Aj.row_offsets), tuple(Aj.col_offsets)
    cn, ron, con = ct.numpy(), ro, co
    assert (ro, co) == (rj, coj)
    for _ in range(2):
        ct, ro, co = tmg._galerkin_coarsen_2d(ct, ro, co)
        cn, ron, con = tmg._galerkin_coarsen_2d(cn, ron, con)
        cj, rj, coj = jmg._galerkin_coarsen_2d(cj, rj, coj)
        assert (ro, co) == (ron, con) == (rj, coj)
        np.testing.assert_array_equal(ct.numpy(), cj)
        np.testing.assert_array_equal(cn, cj)
    x = _rng(12).standard_normal((16, 8, 3))
    np.testing.assert_array_equal(tmg._block_restrict(torch.as_tensor(x), 2, 0.5).numpy(),
                                  np.asarray(jmg._block_restrict(jnp.asarray(x), 2, 0.5)))
    np.testing.assert_array_equal(tmg._block_prolong(torch.as_tensor(x), 2).numpy(),
                                  np.asarray(jmg._block_prolong(jnp.asarray(x), 2)))


# the reference's transfers, each compiled once a shape (eagerly, every op
# of them compiles on its own)
_ref_restrict = jax.jit(jmg._lin_restrict, static_argnums=(1, 2))
_ref_prolong = jax.jit(jmg._lin_prolong, static_argnums=(1,))


@pytest.mark.parametrize("shape", [(64, 16), (8, 16), (32, 8, 8), (64, 16, 3)])
def test_sharded_transfers_equal_reference(pool, shape):  # noqa: F811
    """The sharded restriction and prolongation on four ranks, gathered,
    against the reference's single-device transfer of the whole vector:
    2-D, two grid rows a rank (one coarse row: both ghost terms on one
    row), 3-D, and a trailing column axis (``nd`` counts the grid axes)."""
    x = _rng(13).standard_normal(shape)
    nd = 2 if shape == (64, 16, 3) else len(shape)
    scale = 4.0 / 2 ** nd
    got_r, got_p = pool.run(_spawn.transfer_job, x, nd, scale)["x"]
    want_r = np.asarray(_ref_restrict(jnp.asarray(x), nd, scale))
    want_p = np.asarray(_ref_prolong(jnp.asarray(x), nd))
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-14)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# sharded solves (tests/test_parallel.py's sharded multigrid cases)
# ---------------------------------------------------------------------------


def test_sharded_multigrid_full_coupling_matches_single_device(pool):  # noqa: F811
    """The fully coupled cycle reproduces the single-device V-cycle's
    iteration count whatever the rank count."""
    A = tst.poisson_2d_const(128, 128, dtype=np.float64)
    b = _rng(91).standard_normal((128, 128))
    job = pool.submit(_spawn.solve_job, kt.cg, A, b,
                      M_factory=kt.multigrid_factory(coupling="full"), tol=1e-8, maxiter=200)
    ref_steps = _reference_single_mg_steps()
    res = job.result()
    assert res["info"][0] and _residual(A, res["x"], b) <= 1e-7
    assert abs(res["info"][1] - ref_steps) <= 2
    _, single = kt.cg(A, torch.as_tensor(b), M=kt.MultigridPreconditioner(A),
                      inner=lambda u, v: torch.sum(u * v), tol=1e-8, maxiter=200)
    assert abs(res["info"][1] - single.numsteps) <= 2
    per = res["per_rank"]
    assert all(p["collectives"]["all_gather"] > 0 and p["collectives"]["exchange"] > 0
               for p in per)


def test_sharded_multigrid_local_coupling_and_3d(pool):  # noqa: F811
    """``coupling="local"``: a V-cycle a slab, no traffic between ranks in
    the preconditioner; the 3-D collapsed layout shards whole x-planes, a
    blocked right-hand side rides along (auto takes ``full``)."""
    rng = _rng(92)
    A = tst.poisson_2d_const(128, 128, dtype=np.float64)
    b = rng.standard_normal((128, 128))
    job = pool.submit(_spawn.solve_job, kt.cg, A, b,
                      M_factory=kt.multigrid_factory(coupling="local"), tol=1e-8, maxiter=400)
    res = job.result()
    assert res["info"][0] and res["info"][1] <= 120
    assert _residual(A, res["x"], b) <= 1e-7
    # the only exchanges are the solve's matvecs: one a step and the final residual
    assert all(p["collectives"]["all_gather"] == 1 for p in res["per_rank"])

    A3 = tst.poisson_3d_const(32, 16, 16, dtype=np.float64)
    B3 = rng.standard_normal((32 * 16, 16, 2))
    res = pool.run(_spawn.solve_job, kt.cg, A3, B3, M_factory=kt.multigrid_factory(),
                   tol=1e-8, maxiter=200)
    assert res["info"][0] and res["info"][1] <= 25
    assert _residual(A3, res["x"], B3) <= 1e-7


@functools.cache
def _ref_galerkin(case):
    A, b = _galerkin_case(case, jst)
    _, info = jpar.sharded_solve(krylov_tpu.cg, A, jnp.asarray(b),
                                 mesh=jpar.make_mesh(n_rows=RANKS),
                                 M_factory=krylov_tpu.multigrid_factory(), tol=1e-9,
                                 maxiter=400)
    return info


def _galerkin_case(case, pkg):
    if case == "smooth":
        return pkg.diffusion_2d(_smooth_field(128, 128)), _rng(95).standard_normal((128, 128))
    return pkg.diffusion_2d(_padded_field()), _rng(96).standard_normal((67, 32, 2))


def test_sharded_galerkin_multigrid_variable_coefficients(pool):  # noqa: F811
    """Variable coefficients take the distributed Galerkin cycle: each
    rank coarsens its own slab, the smoothers exchange halos at every level,
    and the gathered coarse problem coarsens on to a dense inverse."""
    A, b = _galerkin_case("smooth", tst)
    job = pool.submit(_spawn.solve_job, kt.cg, A, b, M_factory=kt.multigrid_factory(),
                      tol=1e-9, maxiter=400)
    res = held(job, _ref_galerkin("smooth"))
    assert res["info"][0] and res["info"][1] <= 40
    assert _residual(A, res["x"], b) <= 1e-7
    _, plain = kt.cg(A, torch.as_tensor(b), inner=lambda u, v: torch.sum(u * v), tol=1e-9,
                     maxiter=4000, backend="while_loop")
    assert res["info"][1] * 10 <= plain.numsteps


def test_sharded_galerkin_multigrid_padded_and_multirhs(pool):  # noqa: F811
    """A prime grid-row count rides the unit-diagonal padding; blocked
    columns ride the same cycle; ``coupling="local"`` refuses."""
    A, B = _galerkin_case("padded", tst)
    job = pool.submit(_spawn.solve_job, kt.cg, A, B, M_factory=kt.multigrid_factory(),
                      tol=1e-9, maxiter=400)
    res = held(job, _ref_galerkin("padded"))
    assert res["info"][0] and _residual(A, res["x"], B) <= 1e-7

    mesh = tpar.make_mesh(device="cpu")  # a world of one in this process
    A_l = tpar.ShardedGridStencilOperator(A.coeffs2d, A.offsets, A.ny, mesh, hermitian=True)
    with pytest.raises(ValueError, match="local"):
        kt.multigrid_factory(coupling="local")(A_l)


def test_sharded_multigrid_padded_falls_back_to_local(pool):  # noqa: F811
    """A prime grid-row count: padding breaks the coarsening across slabs,
    so ``auto`` takes the slab-local cycle, masked at the padded rows;
    ``coupling="full"`` refuses."""
    A = tst.poisson_2d_const(67, 16, dtype=np.float64)
    b = _rng(93).standard_normal(67 * 16)
    res = pool.run(_spawn.solve_job, kt.cg, A, b, M_factory=kt.multigrid_factory(),
                   tol=1e-9, maxiter=600)
    assert res["info"][0] and np.isfinite(res["x"]).all()
    assert _residual(A, res["x"], b) <= 1e-8

    mesh = tpar.make_mesh(device="cpu")
    padded = tpar.ShardedConstStencilOperator(A, 17, mesh, m_valid=67)  # a slab of 68 rows
    with pytest.raises(ValueError, match="padded grids"):
        kt.multigrid_factory(coupling="full")(padded)
    assert isinstance(kt.multigrid_factory()(padded), tmg._ShardLocalMG)


def test_multigrid_factory_refusals_and_single_device():
    mesh = tpar.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="coupling"):
        kt.multigrid_factory(coupling="global")
    with pytest.raises(TypeError, match="ConstStencilOperator"):
        kt.multigrid_factory()(tst.poisson_2d(16, 16))
    A3 = tst.poisson_3d_const(8, 4, 16, dtype=np.float64)
    ragged = tpar.ShardedConstStencilOperator(A3, 6, mesh)  # 6 rows: not whole 4-row planes
    with pytest.raises(ValueError, match="does not tile"):
        kt.multigrid_factory()(ragged)
    with pytest.raises(ValueError, match="does not tile"):
        kt.ShardedMultigridPreconditioner(ragged)
    with pytest.raises(TypeError, match="ShardedConstStencilOperator"):
        kt.ShardedMultigridPreconditioner(tst.poisson_2d_const(16, 16))
    A = tst.poisson_2d_const(32, 32, dtype=np.float64)
    M = kt.multigrid_factory()(A)  # a plain operator: the single-device cycle
    assert isinstance(M, kt.MultigridPreconditioner)
    b = torch.as_tensor(_rng(94).standard_normal(1024))
    Mj = jmg.multigrid_factory()(jst.poisson_2d_const(32, 32, dtype=np.float64))
    np.testing.assert_allclose((M @ b).numpy(), np.asarray(Mj @ jnp.asarray(b.numpy())),
                               rtol=1e-12, atol=1e-13)
    # on a world of one the full cycle is a V-cycle on the whole grid
    sharded = kt.multigrid_factory()(tpar.ShardedConstStencilOperator(A, 32, mesh))
    assert isinstance(sharded, kt.ShardedMultigridPreconditioner) and sharded.n_levels >= 3
    z = sharded @ b.reshape(32, 32)
    assert z.shape == (32, 32) and torch.isfinite(z).all()
