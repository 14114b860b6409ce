"""krylov_tpu_torch.MultigridPreconditioner, its grid transfers and the plain
versions of the damped-Jacobi sweep kernels K8 and K9, held to the JAX
package on the CPU.

Inputs are made from a seed with numpy and go through both packages.
Float64 V-cycles and MG-CG solves are compared at rtol 1e-10; the sweep
kernels' plain versions against the Pallas kernel bodies in interpret mode
at float32, atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.experimental import pallas as pl

import krylov_tpu
from krylov_tpu import multigrid as jmg
from krylov_tpu.ops import pallas_stencil as ps
from krylov_tpu.ops import stencil as js
import krylov_tpu_torch as kt
from krylov_tpu_torch import convert
from krylov_tpu_torch import multigrid as tmg
from krylov_tpu_torch.ops import cuda_stencil as cs
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU


def _smooth_field(nx, ny):
    """The reference tests' smooth coefficient field 1 + 0.9 sin cos."""
    X, Y = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    return 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)


# (JAX operator, port operator) by name, float64
OPS = {
    "poisson_2d_const(64)": lambda: (js.poisson_2d_const(64, dtype=np.float64),
                                     ts.poisson_2d_const(64, dtype=np.float64)),
    "poisson_3d_const(16,16,8)": lambda: (
        js.poisson_3d_const(16, 16, 8, dtype=np.float64),
        ts.poisson_3d_const(16, 16, 8, dtype=np.float64)),
    "galerkin diffusion_2d(64)": lambda: (js.diffusion_2d(_smooth_field(64, 64)),
                                          ts.diffusion_2d(_smooth_field(64, 64))),
}


def _inner_j(u, v):
    return jnp.sum(u * v)


def _inner_t(u, v):
    return torch.sum(u * v)


def _interpret(kernel, operands, in_specs, M, ny, tm):
    return pl.pallas_call(
        kernel, grid=(M // tm,), in_specs=in_specs,
        out_specs=pl.BlockSpec((tm, ny), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, ny), jnp.float32), interpret=True,
    )(*operands)


@pytest.mark.parametrize("update", [True, False])
def test_k8_plain_matches_pallas_interpret(update):
    """K8 (``z + w (r - A z)`` / ``r - A z``, const bands) against
    ``_jacobi_sweep_kernel``, 2-D and 3-D, f32 at atol 1e-5."""
    for Aj, At in ((js.poisson_2d_const(16, 8), ts.poisson_2d_const(16, 8)),
                   (js.poisson_3d_const(4, 4, 8), ts.poisson_3d_const(4, 4, 8))):
        M, ny = At.grid
        rng = np.random.default_rng(1)
        z, r = (rng.standard_normal((M, ny)).astype(np.float32) for _ in range(2))
        w, tm = 0.2, 8
        h = cs.halo_rows([b[0] for b in At.kernel_bands])
        zt, zb = ps._halo_planes(jnp.asarray(z), M // tm, tm, h)
        blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
        halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
        want = _interpret(
            functools.partial(ps._jacobi_sweep_kernel, bands=Aj.kernel_bands, h=h,
                              tm=tm, ny=ny, update=update),
            (jnp.full((1, 1), w, jnp.float32), jnp.asarray(z), jnp.asarray(r), zt, zb),
            [pl.BlockSpec((1, 1), lambda i: (0, 0)), blk, blk, halo, halo], M, ny, tm)
        out = torch.empty(M, ny)
        got = cs.jacobi_sweep_const(w, torch.from_numpy(z), torch.from_numpy(r),
                                    At.kernel_bands, update=update, out=out)
        assert got is out
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("update", [True, False])
def test_k9_plain_matches_pallas_interpret(update):
    """K9 (weight plane, coefficient planes) against
    ``_jacobi_sweep_var_kernel``: 5 bands, and a seeded 25-band stack with
    offsets in [-2, 2]^2; f32 at atol 1e-5."""
    rng = np.random.default_rng(2)
    M, ny, tm = 16, 8, 8
    A5 = js.diffusion_2d(0.5 + rng.random((M, ny)), dtype=np.float32)
    pairs = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    c25 = rng.standard_normal((25, M, ny)).astype(np.float32)
    for d, (a, b) in enumerate(pairs):  # the stencil contract: zero off-grid links
        i, j = np.meshgrid(np.arange(M), np.arange(ny), indexing="ij")
        c25[d][(i + a < 0) | (i + a >= M) | (j + b < 0) | (j + b >= ny)] = 0
    cases = [(np.array(A5.coeffs2d), A5.row_offsets, A5.col_offsets),
             (c25, tuple(p[0] for p in pairs), tuple(p[1] for p in pairs))]
    for c, ro, co in cases:
        z, r = (rng.standard_normal((M, ny)).astype(np.float32) for _ in range(2))
        w = (0.1 + rng.random((M, ny))).astype(np.float32)
        h = cs.halo_rows(ro)
        zt, zb = ps._halo_planes(jnp.asarray(z), M // tm, tm, h)
        blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
        halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
        c_spec = pl.BlockSpec((len(ro), tm, ny), lambda i: (0, i, 0))
        head = ((jnp.asarray(c), jnp.asarray(w)), [c_spec, blk]) if update else \
            ((jnp.asarray(c),), [c_spec])
        want = _interpret(
            functools.partial(ps._jacobi_sweep_var_kernel, row_offsets=ro,
                              col_offsets=co, h=h, tm=tm, ny=ny, update=update),
            head[0] + (jnp.asarray(z), jnp.asarray(r), zt, zb),
            head[1] + [blk, blk, halo, halo], M, ny, tm)
        got = cs.jacobi_sweep_var(torch.from_numpy(w), torch.from_numpy(z),
                                  torch.from_numpy(r), torch.from_numpy(c), ro, co,
                                  update=update)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,nd", [((16, 8), 2), ((8, 4, 8), 3), ((16, 8, 3), 2)])
def test_transfers_match_reference(shape, nd):
    """Multilinear prolongation and its scaled transpose over the leading
    ``nd`` axes (trailing axes ride along), f64 at atol 1e-14."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal(shape)
    c = rng.standard_normal(tuple(s // 2 for s in shape[:nd]) + shape[nd:])
    np.testing.assert_allclose(
        tmg._lin_restrict(torch.from_numpy(f), nd, 0.5).numpy(),
        np.asarray(jax.jit(jmg._lin_restrict, static_argnums=(1, 2))(f, nd, 0.5)),
        rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        tmg._lin_prolong(torch.from_numpy(c), nd).numpy(),
        np.asarray(jax.jit(jmg._lin_prolong, static_argnums=1)(c, nd)), rtol=0, atol=1e-14)


@pytest.mark.parametrize("nx,ny", [(32, 32), (64, 16)])
def test_galerkin_levels_are_ptap(nx, ny):
    """Every Galerkin level's matvec equals scipy's P^T A P, f64 at 1e-12.

    On 64x16 the third level is 16x4, where two of its 25 (dr, dc) offsets
    share a flat offset; the port keeps scipy's pairs, while the reference
    decomposes flat offsets and applies a different operator there (its
    cycle never applies that level: it goes through the dense inverse)."""
    a = np.exp(np.random.default_rng(4).standard_normal((nx, ny)))
    Aj, At = js.diffusion_2d(a), ts.diffusion_2d(a)
    Mt, Mj = kt.MultigridPreconditioner(At), krylov_tpu.MultigridPreconditioner(Aj)
    assert Mt.n_levels == Mj.n_levels
    A_sp = At.toscipy()
    shape = (nx, ny)
    rng = np.random.default_rng(5)
    for level in range(1, Mt.n_levels):
        P = scipy.sparse.kron(tmg._bilinear_P_1d(shape[0] // 2),
                              tmg._bilinear_P_1d(shape[1] // 2))
        A_sp = P.T @ A_sp @ P
        shape = (shape[0] // 2, shape[1] // 2)
        x = rng.standard_normal(shape)
        want = A_sp @ x.reshape(-1)
        op = Mt._ops[level]
        pairs = list(zip(op.row_offsets, op.col_offsets))
        assert op.grid == shape and len(set(pairs)) == len(pairs) >= 21
        np.testing.assert_allclose((op @ torch.from_numpy(x)).numpy().reshape(-1),
                                   want, rtol=0, atol=1e-12)
        ref = np.asarray(Mj._ops[level] @ jnp.asarray(x)).reshape(-1)
        if shape[1] == 4:  # the reference's flat-offset collision
            assert np.abs(ref - want).max() > 1e-3
        else:
            np.testing.assert_allclose(ref, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(OPS))
def test_vcycle_matches_reference(name):
    """One V-cycle on a grid right-hand side against the reference's, f64
    at rtol 1e-10; flat and blocked (M, ny, 3) right-hand sides against
    the port's own grid cycle (columns independent, as the reference's
    tests hold it).  CPU tensors launch nothing."""
    Aj, At = OPS[name]()
    Mj, Mt = krylov_tpu.MultigridPreconditioner(Aj), kt.MultigridPreconditioner(At)
    assert Mt.n_levels == Mj.n_levels and Mt.hermitian
    rng = np.random.default_rng(6)
    cs.reset_launches()
    r = rng.standard_normal(At.grid)
    want = np.asarray(Mj @ jnp.asarray(r))
    z = Mt @ torch.from_numpy(r)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    zf = Mt @ torch.from_numpy(r.reshape(-1))
    np.testing.assert_allclose(zf.numpy(), z.numpy().reshape(-1), rtol=1e-13, atol=1e-14)
    rk = np.stack([r, rng.standard_normal(At.grid), -r], axis=-1)
    zk = Mt @ torch.from_numpy(rk)
    assert tuple(zk.shape) == rk.shape
    np.testing.assert_allclose(zk[..., 0].numpy(), z.numpy(), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(zk[..., 2].numpy(), -z.numpy(), rtol=1e-13, atol=1e-14)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0)


@pytest.mark.parametrize("name", list(OPS))
def test_mg_cg_matches_reference(name):
    """MG-preconditioned CG, f64, the port's while_loop against the
    reference's eager backend (its compiled one takes the same steps; it
    is left out here for its compile time): equal numsteps, resnorm
    histories at rtol 1e-10 and solutions at rtol 1e-9."""
    Aj, At = OPS[name]()
    b = np.random.default_rng(7).standard_normal(At.grid)
    xj, info_j = krylov_tpu.cg(Aj, jnp.asarray(b), M=krylov_tpu.MultigridPreconditioner(Aj),
                               inner=_inner_j, tol=1e-8, maxiter=40)
    x, info = kt.cg(At, torch.from_numpy(b), M=kt.MultigridPreconditioner(At),
                    inner=_inner_t, tol=1e-8, maxiter=40, backend="while_loop")
    assert info.success and info.numsteps == int(info_j.numsteps) <= 12
    np.testing.assert_allclose(info.resnorms, np.asarray(info_j.resnorms), rtol=1e-10,
                               atol=1e-14 * info.resnorms[0])
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_convert_multigrid_round_trip():
    """``from_reference`` carries a reference cycle across level by level:
    const and Galerkin hierarchies give the reference's V-cycle (f64)."""
    rng = np.random.default_rng(8)
    for name in ("poisson_2d_const(64)", "galerkin diffusion_2d(64)"):
        Aj, _ = OPS[name]()
        Mj = krylov_tpu.MultigridPreconditioner(Aj)
        Mt = convert.from_reference(Mj)
        assert isinstance(Mt, kt.MultigridPreconditioner)
        assert Mt.n_levels == Mj.n_levels and Mt.dtype == torch.float64
        r = rng.standard_normal(Mt._ops[0].grid)
        np.testing.assert_allclose((Mt @ torch.from_numpy(r)).numpy(),
                                   np.asarray(Mj @ jnp.asarray(r)), rtol=1e-10,
                                   atol=1e-13)


def test_mg_f32_weight_rounds_to_the_operator_dtype():
    """An f32 operator's Jacobi weight is omega/center rounded to f32, as
    the reference's; odd dims stop coarsening as there."""
    M = kt.MultigridPreconditioner(ts.poisson_2d_const(24, 18))
    Mj = krylov_tpu.MultigridPreconditioner(js.poisson_2d_const(24, 18))
    assert M.n_levels == Mj.n_levels == 2
    assert M._winv[0] == float(np.asarray(Mj._winv[0])) == float(np.float32(0.2))
    assert M._coarse_inv.dtype == torch.float32


def test_mg_rejects_what_the_reference_rejects():
    with pytest.raises(TypeError, match="ConstStencilOperator"):
        kt.MultigridPreconditioner(ts.poisson_1d(16))
    nonherm = ts.GridStencilOperator(torch.ones(3, 8, 8), (-8, 0, 1), 8)
    with pytest.raises(ValueError, match="hermitian"):
        kt.MultigridPreconditioner(nonherm)
