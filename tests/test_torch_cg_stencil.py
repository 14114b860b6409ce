"""krylov_tpu_torch.cg_stencil and the fused CG kernels' plain versions (K5,
K4), held to the JAX package on the CPU.

The plain versions are compared with the Pallas kernel bodies run in
interpret mode (f32, atol 1e-5).  Float32 CG trajectories of two packages
agree only while rounding differences stay small, so the f32 solves run a
few steps unconverged (rtol 1e-4); float64 solves are compared whole
(rtol 1e-10).  Coefficients a in [0.5, 1.5] keep the diffusion operator
mild: on i.i.d. lognormal coefficients f32 rounding grows tenfold per step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import krylov_tpu
from krylov_tpu.ops import pallas_stencil as ps
from krylov_tpu.ops import stencil as js
import krylov_tpu_torch as kt
from krylov_tpu_torch.ops import cuda_stencil as cs
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)


def _mild(shape, seed=21):
    return 0.5 + np.random.default_rng(seed).random(shape)


def _ops(dtype, shape=(16, 8)):
    a = _mild(shape)
    return js.diffusion_2d(a, dtype=dtype), ts.diffusion_2d(a, dtype=dtype)


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


def test_k5_plain_matches_pallas_interpret():
    """K5: p_new = r + omega p, Ap, <p_new, Ap> against ``_cg_a_var_kernel``."""
    Aj, At = _ops(np.float32)
    M, ny = At.grid
    rng = np.random.default_rng(22)
    r, p = _f32(rng.standard_normal((M, ny)), rng.standard_normal((M, ny)))
    omega = 0.7
    h, tm, nb = 1, 8, 2
    rj, pj = jnp.asarray(r), jnp.asarray(p)
    rt, rb = ps._halo_planes(rj, nb, tm, h)
    pt, pb = ps._halo_planes(pj, nb, tm, h)
    ndiag = Aj.coeffs2d.shape[0]
    halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
    blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
    with jax.disable_jit():
        pn, ap, pap = pl.pallas_call(
            functools.partial(ps._cg_a_var_kernel, row_offsets=Aj.row_offsets,
                              col_offsets=Aj.col_offsets, h=h, tm=tm, ny=ny),
            grid=(nb,),
            in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0)),
                      pl.BlockSpec((ndiag, tm, ny), lambda i: (0, i, 0)),
                      blk, blk, halo, halo, halo, halo],
            out_specs=(blk, blk, pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))),
            out_shape=(jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((nb, 8, 128), jnp.float32)),
            interpret=True,
        )(jnp.full((1, 1), omega, jnp.float32),
          jnp.asarray(Aj.coeffs2d, jnp.float32), rj, pj, rt, rb, pt, pb)
    got = cs.cg_fused_phase_a_var(
        torch.tensor(omega, dtype=torch.float32), torch.from_numpy(r),
        torch.from_numpy(p), At.coeffs2d, At.row_offsets, At.col_offsets,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pn), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ap), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(jnp.sum(pap)), rtol=1e-5)


def test_k4_plain_matches_pallas_interpret():
    """K4: y += alpha p, r -= alpha Ap (in place), <r, r> against
    ``_cg_b_kernel``."""
    M, ny, tm, nb = 16, 8, 8, 2
    rng = np.random.default_rng(23)
    y, r, p, ap = _f32(*rng.standard_normal((4, M, ny)))
    alpha = 0.3
    blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
    with jax.disable_jit():
        yn, rn, rho = pl.pallas_call(
            ps._cg_b_kernel,
            grid=(nb,),
            in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0)), blk, blk, blk, blk],
            out_specs=(blk, blk, pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))),
            out_shape=(jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((nb, 8, 128), jnp.float32)),
            interpret=True,
        )(jnp.full((1, 1), alpha, jnp.float32), *map(jnp.asarray, (y, r, p, ap)))
    yt, rt = torch.from_numpy(y.copy()), torch.from_numpy(r.copy())
    got = cs.cg_fused_phase_b(torch.tensor(alpha, dtype=torch.float32), yt, rt,
                              torch.from_numpy(p), torch.from_numpy(ap))
    assert got[0] is yt and got[1] is rt  # updated in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yn), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rn), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(jnp.sum(rho)), rtol=1e-5)


def test_k5_writes_given_out_buffers():
    """``out=(p_new, Ap)`` is honoured and returned; p is left as it was."""
    _, At = _ops(np.float32)
    r = torch.ones(At.grid)
    p = torch.zeros(At.grid)
    pn, ap = torch.empty(At.grid), torch.empty(At.grid)
    out = cs.cg_fused_phase_a_var(torch.tensor(0.5), r, p, At.coeffs2d,
                                  At.row_offsets, At.col_offsets, out=(pn, ap))
    assert out[0] is pn and out[1] is ap
    assert torch.equal(pn, r) and torch.equal(p, torch.zeros(At.grid))


@pytest.mark.parametrize("steps", [1, 6])
def test_fused_f32_matches_reference(steps):
    """cg_stencil(fused=True) in f32 (plain K5/K4 here) against the
    reference's cg_stencil over the first steps, unconverged."""
    Aj, At = _ops(np.float32)
    b = np.random.default_rng(24).standard_normal(At.grid).astype(np.float32)
    x, info = kt.cg_stencil(At, torch.from_numpy(b), tol=0.0, atol=0.0,
                            maxiter=steps, fused=True)
    xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(b), tol=0.0, atol=0.0,
                                       maxiter=steps, fused=True)
    assert x is None and xj is None and info.numsteps == info_j.numsteps == steps
    np.testing.assert_allclose(info.resnorms, np.asarray(info_j.resnorms), rtol=1e-4)
    np.testing.assert_allclose(info.xk.numpy(), np.asarray(info_j.xk), rtol=1e-4,
                               atol=1e-5)


def test_fused_matches_own_cg():
    """The fused recurrence and the generic one run the same arithmetic on
    the CPU: a converged f32 solve agrees step for step (rtol 1e-5)."""
    _, At = _ops(np.float32)
    b = torch.from_numpy(
        np.random.default_rng(25).standard_normal(At.grid).astype(np.float32))
    b_copy = b.clone()
    x, info = kt.cg_stencil(At, b, tol=1e-5, fused=True)
    xg, info_g = kt.cg(At, b, inner=lambda u, v: torch.sum(u * v), tol=1e-5,
                       backend="while_loop")
    assert info.success and info_g.success and info.numsteps == info_g.numsteps
    np.testing.assert_allclose(info.resnorms, info_g.resnorms, rtol=1e-5)
    torch.testing.assert_close(x, xg, rtol=1e-5, atol=1e-6)
    assert torch.equal(b, b_copy)  # the in-place phase B never touches b
    rel = torch.linalg.norm(b - At @ x) / torch.linalg.norm(b)
    assert float(rel) <= 1e-5


@pytest.mark.parametrize("M", [None, "jacobi"])
def test_f64_matches_reference(M):
    """Float64 (the unfused composition of K1 and elementwise ops) against
    the reference, whole converged solves, rtol 1e-10."""
    Aj, At = _ops(np.float64)
    b = np.random.default_rng(26).standard_normal(At.grid)
    x, info = kt.cg_stencil(At, torch.from_numpy(b), tol=1e-8, M=M, fused=True)
    xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(b), tol=1e-8, M=M,
                                       fused=True)
    assert info.success and info.numsteps == int(info_j.numsteps)
    np.testing.assert_allclose(info.resnorms, np.asarray(info_j.resnorms),
                               rtol=1e-10, atol=1e-14 * info.resnorms[0])
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_flat_rhs_x0_and_unconverged():
    Aj, At = _ops(np.float64)
    rng = np.random.default_rng(27)
    b, x0 = rng.standard_normal(128), rng.standard_normal(128)
    x, info = kt.cg_stencil(At, torch.from_numpy(b), x0=torch.from_numpy(x0),
                            tol=1e-9)
    xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(b), x0=jnp.asarray(x0),
                                       tol=1e-9)
    assert tuple(x.shape) == (128,) and info.numsteps == int(info_j.numsteps)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)
    xn, infon = kt.cg_stencil(At, torch.from_numpy(b), tol=1e-30, atol=0.0,
                              maxiter=3)
    assert xn is None and not infon.success and infon.numsteps == 3


def test_unported_variants_raise():
    from krylov_tpu.ops.stencil import poisson_2d_const

    _, At = _ops(np.float32)
    # the reference's own operator is not the port's: carry it across with
    # krylov_tpu_torch.convert.from_reference
    with pytest.raises(TypeError, match="ConstStencilOperator or GridStencilOperator"):
        kt.cg_stencil(poisson_2d_const(8, 8), torch.ones(8, 8))
    with pytest.raises(NotImplementedError, match="K6/K7"):
        kt.cg_stencil(At, torch.ones(At.grid), M="jacobi", fused=True)
    with pytest.raises(ValueError):
        kt.cg_stencil(At, torch.ones(At.grid), M="ilu")
