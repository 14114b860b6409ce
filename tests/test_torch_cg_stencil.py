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
kt.set_default_device("cpu")  # these tests run on the CPU


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
    with pytest.raises(ValueError):
        kt.cg_stencil(At, torch.ones(At.grid), M="ilu")


# --- K6 / K7: fused Jacobi-preconditioned CG ---------------------------------


def _jac_inputs(At, seed):
    M, ny = At.grid
    rng = np.random.default_rng(seed)
    y, r, p = _f32(*rng.standard_normal((3, M, ny)))
    dinv = (1.0 / At.diagonal().reshape(M, ny)).numpy().astype(np.float32)
    return y, r, p, dinv


def test_k6_k7_plain_match_pallas_interpret():
    """K6 (p_new = dinv r + omega p, Ap, <p_new, Ap>) and K7 (y += alpha p,
    r -= alpha Ap in place, <r, dinv r>) against ``_cg_a_var_jac_kernel`` and
    ``_cg_b_jac_kernel`` in interpret mode at 16 x 8: rtol 1e-5 / atol 1e-6
    on the vectors (float32 sums in another order), rtol 1e-4 on the sums."""
    Aj, At = _ops(np.float32)
    M, ny = At.grid
    y, r, p, dinv = _jac_inputs(At, 28)
    omega, alpha = 0.6, 0.3
    h, tm, nb = 1, 8, 2
    rj, pj, dj = jnp.asarray(r), jnp.asarray(p), jnp.asarray(dinv)
    rt, rb = ps._halo_planes(rj, nb, tm, h)
    pt, pb = ps._halo_planes(pj, nb, tm, h)
    dt, db = ps._halo_planes(dj, nb, tm, h)
    ndiag = Aj.coeffs2d.shape[0]
    halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
    blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
    scalar = pl.BlockSpec((1, 1), lambda i: (0, 0))
    outs = dict(
        out_specs=(blk, blk, pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((M, ny), jnp.float32),
                   jax.ShapeDtypeStruct((M, ny), jnp.float32),
                   jax.ShapeDtypeStruct((nb, 8, 128), jnp.float32)),
        interpret=True,
    )
    with jax.disable_jit():
        pn, ap, pap = pl.pallas_call(
            functools.partial(ps._cg_a_var_jac_kernel, row_offsets=Aj.row_offsets,
                              col_offsets=Aj.col_offsets, h=h, tm=tm, ny=ny),
            grid=(nb,),
            in_specs=[scalar, pl.BlockSpec((ndiag, tm, ny), lambda i: (0, i, 0)),
                      blk, blk, blk, halo, halo, halo, halo, halo, halo],
            **outs,
        )(jnp.full((1, 1), omega, jnp.float32), jnp.asarray(Aj.coeffs2d, jnp.float32),
          dj, rj, pj, rt, rb, pt, pb, dt, db)
        yn, rn, rho = pl.pallas_call(
            ps._cg_b_jac_kernel, grid=(nb,),
            in_specs=[scalar, blk, blk, blk, blk, blk], **outs,
        )(jnp.full((1, 1), alpha, jnp.float32), dj, jnp.asarray(y), rj, pn, ap)

    rt_, pt_, dt_ = (torch.from_numpy(a.copy()) for a in (r, p, dinv))
    got = cs.cg_fused_phase_a_var_jac(
        torch.tensor(omega, dtype=torch.float32), rt_, pt_, At.coeffs2d, dt_,
        At.row_offsets, At.col_offsets)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ap), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(jnp.sum(pap)), rtol=1e-4)
    assert torch.equal(pt_, torch.from_numpy(p))  # p is left as it was

    yt = torch.from_numpy(y.copy())
    gb = cs.cg_fused_phase_b_jac(torch.tensor(alpha, dtype=torch.float32), yt, rt_,
                                 got[0], got[1], dt_)
    assert gb[0] is yt and gb[1] is rt_  # updated in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt_.numpy(), np.asarray(rn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(gb[2]), float(jnp.sum(rho)), rtol=1e-4)


def test_k6_k7_plain_update_formulas_ragged_grid():
    """At a grid whose M is not a multiple of 8 (13 x 9) the plain versions
    against the update formulas written out with the operator's matvec
    (rtol 1e-5 / atol 1e-6; sums rtol 1e-4); ``out=`` is honoured."""
    _, At = _ops(np.float32, shape=(13, 9))
    y, r, p, dinv = (torch.from_numpy(a) for a in _jac_inputs(At, 29))
    omega, alpha = torch.tensor(0.45), torch.tensor(0.2)
    pn_buf, ap_buf = torch.empty(At.grid), torch.empty(At.grid)
    pn, ap, pap = cs.cg_fused_phase_a_var_jac(
        omega, r, p, At.coeffs2d, dinv, At.row_offsets, At.col_offsets,
        out=(pn_buf, ap_buf))
    assert pn is pn_buf and ap is ap_buf
    pn_ref = dinv * r + omega * p
    ap_ref = At @ pn_ref
    torch.testing.assert_close(pn, pn_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ap, ap_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pap, torch.sum(pn_ref * ap_ref), rtol=1e-4, atol=0)
    y0, r0 = y.clone(), r.clone()
    _, _, rho = cs.cg_fused_phase_b_jac(alpha, y, r, pn, ap, dinv)
    rn_ref = r0 - alpha * ap
    torch.testing.assert_close(y, y0 + alpha * pn, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r, rn_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rho, torch.sum(rn_ref * (dinv * rn_ref)), rtol=1e-4, atol=0)


@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
def test_fused_jacobi_f32_matches_reference_and_generic_cg(shape):
    """cg_stencil(M="jacobi", fused=True) in float32 (the plain K6/K7 here)
    against the reference's (its unfused step off the TPU) and against the
    port's generic cg with M = DiagonalOperator(dinv): numsteps within one,
    trajectories within rtol 2e-3 (the float32 band of these solves),
    solutions within 1e-4 relative."""
    a = 0.5 + np.random.default_rng(30).random(shape)
    Aj, At = js.diffusion_2d(a, dtype=np.float32), ts.diffusion_2d(a, dtype=np.float32)
    b = np.random.default_rng(31).standard_normal(shape).astype(np.float32)
    bt = torch.from_numpy(b)
    launches = dict(cs.LAUNCHES)
    x, info = kt.cg_stencil(At, bt, tol=1e-5, M="jacobi", fused=True)
    assert cs.LAUNCHES == launches  # plain versions count nothing
    xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(b), tol=1e-5, M="jacobi",
                                       fused=True)
    dinv = 1.0 / At.diagonal().reshape(shape)
    xg, info_g = kt.cg(At, bt, M=kt.DiagonalOperator(dinv), tol=1e-5,
                       inner=lambda u, v: torch.sum(u * v), backend="while_loop")
    assert info.success and bool(info_j.success) and info_g.success
    assert torch.equal(bt, torch.from_numpy(b))  # phase B never touches b
    for other, xo in ((info_j, np.asarray(xj)), (info_g, xg.numpy())):
        assert abs(info.numsteps - int(other.numsteps)) <= 1
        m = min(info.numsteps, int(other.numsteps))  # the recurrence entries
        np.testing.assert_allclose(info.resnorms[:m], np.asarray(other.resnorms)[:m],
                                   rtol=2e-3)
        assert np.linalg.norm(x.numpy() - xo) <= 1e-4 * np.linalg.norm(xo)
    rel = torch.linalg.norm(bt - At @ x) / torch.linalg.norm(bt)
    assert float(rel) <= 1e-4


def test_fused_jacobi_takes_a_numpy_rhs_and_counts_operations():
    _, At = _ops(np.float32)
    b = np.ones(At.grid, np.float32)
    x, info = kt.cg_stencil(At, b, tol=1e-5, M="jacobi", fused=True)
    k = info.numsteps
    assert info.success and x.device == At.device
    assert info.num_operations == {"A": 1 + k, "M": 2 + k, "Ml": 2 + k, "Mr": 1 + k,
                                   "inner": 2 + 2 * k, "axpy": 2 + 2 * k}
