"""krylov_tpu_torch's constant-coefficient stencil operator, its fused CG and
the plain versions of kernels K2 and K3 (and complex K1), held to the JAX
package on the CPU.

Inputs are made from a seed with numpy and go through both packages.  The
plain versions are compared with the reference's XLA form (float64, atol
1e-13) and with its Pallas kernel bodies in interpret mode (float32 at
atol 1e-5; bfloat16 outputs one bf16 rounding apart, rtol 1e-2).
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
from krylov_tpu_torch import convert
from krylov_tpu_torch.ops import cuda_stencil as cs
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

NONHERM = ([(0, 0), (1, 0), (0, -1), (1, 2), (-2, 1)], [4.0, -1.5, -0.5, 0.25, -0.75])

# (JAX constructor, port constructor) by name, each taking a dtype
OPS = {
    "poisson_2d_const": (lambda dt: js.poisson_2d_const(16, 8, dtype=dt),
                         lambda dt: ts.poisson_2d_const(16, 8, dtype=dt)),
    "poisson_3d_const": (lambda dt: js.poisson_3d_const(4, 4, 8, dtype=dt),
                         lambda dt: ts.poisson_3d_const(4, 4, 8, dtype=dt)),
    "nonhermitian": (lambda dt: js.ConstStencilOperator((16, 8), *NONHERM, dtype=dt),
                     lambda dt: ts.ConstStencilOperator((16, 8), *NONHERM, dtype=dt)),
}


def _pair(name, dtype=np.float64):
    make_j, make_t = OPS[name]
    return make_j(dtype), make_t(dtype)


@pytest.mark.parametrize("kind", ["flat", "grid", "nk", "grid_k"])
@pytest.mark.parametrize("name", list(OPS))
def test_const_matvec_matches_reference(name, kind):
    """All four vector shapes of ``__matmul__`` and ``rmatvec`` against the
    reference's XLA form, f64 at atol 1e-13."""
    Aj, At = _pair(name)
    M, ny = At.grid
    shape = {"flat": (M * ny,), "grid": (M, ny), "nk": (M * ny, 3),
             "grid_k": (M, ny, 3)}[kind]
    x = np.random.default_rng(0).standard_normal(shape)
    got = At @ torch.from_numpy(x)
    assert tuple(got.shape) == shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(Aj @ jnp.asarray(x)),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(At.rmatvec(torch.from_numpy(x)).numpy(),
                               np.asarray(Aj.rmatvec(jnp.asarray(x))), rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", list(OPS))
def test_const_structure_matches_reference(name):
    """Bands, kernel bands, hermitian flag, nnz, diagonal and the scipy twin."""
    Aj, At = _pair(name)
    assert At.bands == Aj.bands and At.kernel_bands == Aj.kernel_bands
    assert At.hermitian == Aj.hermitian and At.nnz == Aj.nnz
    assert At.shape == Aj.shape and At.grid == tuple(Aj.grid)
    assert At.dtype == torch.float64 and isinstance(At.dtype, torch.dtype)
    np.testing.assert_array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))
    assert (At.toscipy() != Aj.toscipy()).nnz == 0
    csr = At.tocsr()  # a CSROperator, as the reference's
    assert type(csr).__name__ == type(Aj.tocsr()).__name__ == "CSROperator"
    np.testing.assert_array_equal(csr.todense().numpy(), np.asarray(Aj.tocsr().todense()))


def test_row0_and_halos_match_reference():
    """A slab's matvec with its global first row and neighbour halos: the
    full bands against the reference's XLA form, f64."""
    rng = np.random.default_rng(1)
    for name in OPS:
        Aj, At = _pair(name)
        M, ny = At.grid
        h = cs.halo_rows([b[0] for b in At.bands])
        x, top, bot = (rng.standard_normal(s) for s in ((M, ny), (h, ny), (h, ny)))
        for row0 in (None, 3):
            want = Aj._apply_grid(jnp.asarray(x), row0=row0, top_halo=jnp.asarray(top),
                                  bot_halo=jnp.asarray(bot))
            got = At._apply_grid(torch.from_numpy(x), row0=row0,
                                 top_halo=torch.from_numpy(top),
                                 bot_halo=torch.from_numpy(bot))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)


def _pallas_k2(x, bands, tm, row0=None, top=None, bot=None):
    """The reference K2 body (``ps._const_kernel``) in Pallas interpret mode,
    with the halo planes ``const_stencil2d_matvec`` builds."""
    M, ny = x.shape
    nb = M // tm
    h = max(abs(b[0]) for b in bands)
    xr = x.reshape(nb, tm, ny)
    zero = jnp.zeros((1, h, ny), x.dtype)
    top0 = zero if top is None else top.astype(x.dtype)[None]
    botn = zero if bot is None else bot.astype(x.dtype)[None]
    tops = jnp.concatenate([top0, xr[:-1, tm - h:]], axis=0)
    bots = jnp.concatenate([xr[1:, :h], botn], axis=0)
    r0 = jnp.full((1, 1), 0 if row0 is None else row0, jnp.int32)
    halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(ps._const_kernel, bands=bands, h=h, tm=tm, ny=ny, masked=True),
        grid=(nb,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0)),
                  pl.BlockSpec((tm, ny), lambda i: (i, 0)), halo, halo],
        out_specs=pl.BlockSpec((tm, ny), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, ny), x.dtype),
        interpret=True,
    )(r0, x, tops, bots)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPS))
def test_k2_plain_matches_pallas_interpret(name, dtype):
    """K2's plain version against ``_const_kernel``: the kernel bands, and
    the full bands with ``row0`` and halos.  bf16 accumulates in f32 in
    both and rounds once on the store."""
    Aj, At = _pair(name, np.float32)
    M, ny = At.grid
    h = cs.halo_rows([b[0] for b in At.bands])
    rng = np.random.default_rng(2)
    x, top, bot = (rng.standard_normal(s).astype(np.float32)
                   for s in ((M, ny), (h, ny), (h, ny)))
    tdt = getattr(torch, dtype)
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for bands, kw in ((Aj.kernel_bands, {}),
                      (Aj.bands, dict(row0=4, top=top, bot=bot))):
        want = _pallas_k2(jnp.asarray(x, dtype), bands, tm=8, row0=kw.get("row0"),
                          top=None if not kw else jnp.asarray(top),
                          bot=None if not kw else jnp.asarray(bot))
        got = cs.const_stencil2d_matvec(
            torch.from_numpy(x).to(tdt), bands, row0=kw.get("row0"),
            top_halo=None if not kw else torch.from_numpy(top),
            bot_halo=None if not kw else torch.from_numpy(bot))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **tol)


def test_k3_plain_matches_pallas_interpret():
    """K3: p_new = r + omega p, Ap (const bands), <p_new, Ap> against
    ``_cg_a_kernel``; f32 at atol 1e-5, the reduction at rtol 1e-5."""
    for name in OPS:
        Aj, At = _pair(name, np.float32)
        M, ny = At.grid
        rng = np.random.default_rng(3)
        r, p = (rng.standard_normal((M, ny)).astype(np.float32) for _ in range(2))
        omega, tm = 0.7, 8
        nb = M // tm
        h = max(1, cs.halo_rows([b[0] for b in At.bands]))
        rj, pj = jnp.asarray(r), jnp.asarray(p)
        rt, rb = ps._halo_planes(rj, nb, tm, h)
        pt, pb = ps._halo_planes(pj, nb, tm, h)
        halo = pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0))
        blk = pl.BlockSpec((tm, ny), lambda i: (i, 0))
        pn, ap, pap = pl.pallas_call(
            functools.partial(ps._cg_a_kernel, bands=Aj.bands, h=h, tm=tm, ny=ny),
            grid=(nb,),
            in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0)), blk, blk,
                      halo, halo, halo, halo],
            out_specs=(blk, blk, pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))),
            out_shape=(jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((M, ny), jnp.float32),
                       jax.ShapeDtypeStruct((nb, 8, 128), jnp.float32)),
            interpret=True,
        )(jnp.full((1, 1), omega, jnp.float32), rj, pj, rt, rb, pt, pb)
        pn_out, ap_out = torch.empty(M, ny), torch.empty(M, ny)
        got = cs.cg_fused_phase_a(torch.tensor(omega), torch.from_numpy(r),
                                  torch.from_numpy(p), At.kernel_bands,
                                  out=(pn_out, ap_out))
        assert got[0] is pn_out and got[1] is ap_out
        np.testing.assert_allclose(got[0].numpy(), np.asarray(pn), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ap), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(got[2]), float(jnp.sum(pap)), rtol=1e-5)


@pytest.mark.parametrize("cdt,xdt", [("complex128", "complex128"),
                                     ("float64", "complex128"),
                                     ("complex64", "complex64")])
def test_complex_k1_plain_matches_reference(cdt, xdt):
    """Complex K1: the plain version against the reference's
    ``_matvec_2d`` on complex coefficients and vectors, accumulating in
    the promoted complex type (atol 1e-12 at complex128, 1e-5 at
    complex64)."""
    rng = np.random.default_rng(4)
    base = js.poisson_2d(8, 12)
    c = np.asarray(base.coeffs2d)
    if cdt.startswith("complex"):
        c = c + 1j * rng.standard_normal(c.shape) * (c != 0)
    c = c.astype(cdt)
    x = (rng.standard_normal((8, 12)) + 1j * rng.standard_normal((8, 12))).astype(xdt)
    Aj = js.GridStencilOperator(jnp.asarray(c), base.offsets, 12)
    At = convert.grid_stencil_from_numpy(c, base.offsets, 12)
    want = Aj._matvec_2d(Aj.coeffs2d, jnp.asarray(x))
    got = cs.stencil2d_matvec(At.coeffs2d, torch.from_numpy(x), At.row_offsets,
                              At.col_offsets)
    assert got.dtype == getattr(torch, xdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 if xdt == "complex128" else 1e-5)


@pytest.mark.parametrize("steps", [1, 6])
def test_fused_const_f32_matches_reference(steps):
    """cg_stencil(fused=True) on the const operator in f32 (plain K3/K4
    here) against the reference's fused solve over its first steps,
    unconverged (rtol 1e-4)."""
    Aj, At = _pair("poisson_2d_const", np.float32)
    b = np.random.default_rng(5).standard_normal(At.grid).astype(np.float32)
    x, info = kt.cg_stencil(At, torch.from_numpy(b), tol=0.0, atol=0.0,
                            maxiter=steps, fused=True)
    xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(b), tol=0.0, atol=0.0,
                                       maxiter=steps, fused=True)
    assert x is None and info.numsteps == int(info_j.numsteps) == steps
    np.testing.assert_allclose(info.resnorms, np.asarray(info_j.resnorms), rtol=1e-4)
    np.testing.assert_allclose(info.xk.numpy(), np.asarray(info_j.xk), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["poisson_2d_const", "poisson_3d_const"])
def test_fused_const_f64_matches_reference(name):
    """Float64 (the unfused composition) against the reference, whole
    converged solves at rtol 1e-10, flat and grid right-hand sides."""
    Aj, At = _pair(name)
    b = np.random.default_rng(6).standard_normal(At.grid)
    for bb in (b, b.reshape(-1)):
        x, info = kt.cg_stencil(At, torch.from_numpy(bb), tol=1e-8, fused=True)
        xj, info_j = krylov_tpu.cg_stencil(Aj, jnp.asarray(bb), tol=1e-8, fused=True)
        assert info.success and info.numsteps == int(info_j.numsteps)
        assert tuple(x.shape) == bb.shape
        np.testing.assert_allclose(info.resnorms, np.asarray(info_j.resnorms),
                                   rtol=1e-10, atol=1e-14 * info.resnorms[0])
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_fused_const_matches_own_cg_and_launches_nothing_on_cpu():
    """The fused const recurrence and generic cg run the same arithmetic:
    a converged f32 solve agrees step for step (rtol 1e-5); on CPU tensors
    no kernel is launched."""
    _, At = _pair("poisson_2d_const", np.float32)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(At.grid)
                         .astype(np.float32))
    cs.reset_launches()
    x, info = kt.cg_stencil(At, b, tol=1e-5, fused=True)
    xg, info_g = kt.cg(At, b, inner=lambda u, v: torch.sum(u * v), tol=1e-5,
                       backend="while_loop")
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0)
    assert info.success and info_g.success and info.numsteps == info_g.numsteps
    np.testing.assert_allclose(info.resnorms, info_g.resnorms, rtol=1e-5)
    torch.testing.assert_close(x, xg, rtol=1e-5, atol=1e-6)


def test_const_laplacians_sum_in_grid_order():
    """The const kernels sum bands in ascending (dr, dc) order, not in the
    reference's listed order (centre first): a const Laplacian's f32 matvec
    then equals the variable-coefficient one's bit for bit, and f32 CG keeps
    to the f64 trajectory (rtol 1e-5 over 60 steps at 128^2; the listed
    order drifts to ~1e-4, see krylov_tpu_torch/ops/cuda_stencil.py)."""
    rng = np.random.default_rng(10)
    for Ac, Av in ((ts.poisson_2d_const(24, 16), ts.poisson_2d(24, 16, dtype=np.float32)),
                   (ts.poisson_3d_const(4, 5, 8),
                    ts.poisson_3d(4, 5, 8, dtype=np.float32))):
        x = torch.from_numpy(rng.standard_normal(Ac.grid).astype(np.float32))
        assert torch.equal(Ac @ x, Av @ x)
        assert [b[:2] for b in cs.grid_order(Ac.bands)] == list(zip(Av.row_offsets,
                                                                     Av.col_offsets))
    b = torch.ones(128, 128)
    _, i32 = kt.cg_stencil(ts.poisson_2d_const(128), b, tol=0.0, atol=0.0, maxiter=60)
    _, i64 = kt.cg_stencil(ts.poisson_2d_const(128, dtype=np.float64), b.double(),
                           tol=0.0, atol=0.0, maxiter=60)
    np.testing.assert_allclose(i32.resnorms, i64.resnorms, rtol=1e-5)


def _bands_within(h, v):
    """A const band set reaching ``h`` rows and ``v`` columns."""
    return ((0, 0, 4.0, ()), (-h, 0, -1.0, ()), (h, 0, -1.0, ()), (0, -v, -1.0, ()),
            (0, v, -1.0, ()))


K2_PATH_CASES = [
    # label, dtype, ny, bands, addresses of x / out / halos, tiled?
    ("the main path: f32 4096^2, aligned", torch.float32, 4096, _bands_within(1, 1),
     (1 << 20, 5 << 20), True),
    ("ragged 1000 x 1500", torch.float32, 1500, _bands_within(1, 1), (256, 512), True),
    ("ny = 4", torch.float32, 4, _bands_within(1, 1), (0, 64), True),
    ("odd ny", torch.float32, 37, _bands_within(1, 1), (256, 512), False),
    ("ny % 4 == 2", torch.float32, 42, _bands_within(1, 1), (256, 512), False),
    ("x a view 4 bytes off", torch.float32, 4096, _bands_within(1, 1), (260, 512), False),
    ("out a view 8 bytes off", torch.float32, 4096, _bands_within(1, 1), (256, 520), False),
    ("halo rows aligned", torch.float32, 64, _bands_within(2, 1), (256, 512, 1024, 2048), True),
    ("a halo 4 bytes off", torch.float32, 64, _bands_within(2, 1), (256, 512, 1028, 2048),
     False),
    ("25 bands", torch.float32, 132,
     tuple((a, b, 1.0, ()) for a in range(-2, 3) for b in range(-2, 3)), (256, 512), True),
    ("3-D, row constraints", torch.float32, 40, ts.poisson_3d_const(5, 6, 40).kernel_bands,
     (256, 512), True),
    ("reach at the ring's limit", torch.float32, 64,
     _bands_within(cs.K2_MAX_HALO, cs.K2_MAX_HALO), (256, 512), True),
    ("rows beyond the ring", torch.float32, 64, _bands_within(cs.K2_MAX_HALO + 1, 1),
     (256, 512), False),
    ("columns beyond the ring", torch.float32, 64, _bands_within(1, cs.K2_MAX_HALO + 1),
     (256, 512), False),
    ("bfloat16", torch.bfloat16, 4096, _bands_within(1, 1), (256, 512), False),
    ("float64", torch.float64, 4096, _bands_within(1, 1), (256, 512), False),
    ("complex64", torch.complex64, 4096, _bands_within(1, 1), (256, 512), False),
    ("complex128", torch.complex128, 4096, _bands_within(1, 1), (256, 512), False),
]


@pytest.mark.parametrize("label,dtype,ny,bands,addresses,tiled", K2_PATH_CASES,
                         ids=[c[0] for c in K2_PATH_CASES])
def test_k2_path_predicate(label, dtype, ny, bands, addresses, tiled):
    """Which of K2's two kernels a call takes follows from its type, its row
    length, its bands' reach and its buffers' alignment alone."""
    assert cs.k2_tiled(dtype, ny, bands, addresses) is tiled


def test_k2_paths_count_nothing_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version whatever the
    predicate says, and counts no launch on either path."""
    A = ts.poisson_2d_const(8, 16, dtype=np.float32)
    x = torch.ones(A.grid)
    assert cs.k2_tiled(x.dtype, 16, A.kernel_bands, [0])
    cs.reset_launches()
    y = cs.const_stencil2d_matvec(x, A.kernel_bands)
    assert cs.K2_PATHS == {"tiled": 0, "general": 0}
    assert cs.LAUNCHES["const_stencil2d_matvec"] == 0
    assert torch.equal(y, cs.const_stencil2d_matvec_plain(x, A.kernel_bands))


def test_const_jacobi_rejected():
    _, At = _pair("poisson_2d_const")
    with pytest.raises(ValueError, match="GridStencilOperator"):
        kt.cg_stencil(At, torch.ones(At.grid, dtype=torch.float64), M="jacobi")


def test_convert_const_round_trip():
    """``from_reference`` carries a const operator across: same bands and
    dtype, equal matvecs."""
    for name in OPS:
        Aj, _ = _pair(name, np.float32)
        At = convert.from_reference(Aj)
        assert isinstance(At, ts.ConstStencilOperator)
        assert At.bands == Aj.bands and At.dtype == torch.float32
        x = np.random.default_rng(8).standard_normal(At.grid)
        np.testing.assert_allclose((At @ torch.from_numpy(x)).numpy(),
                                   np.asarray(Aj @ jnp.asarray(x)), atol=1e-13)


def test_banded_toscipy_and_todense_match_reference():
    for Aj, At in ((js.poisson_1d(7), ts.poisson_1d(7)),
                   (js.diffusion_2d(0.5 + np.random.default_rng(9).random((6, 5))),
                    ts.diffusion_2d(0.5 + np.random.default_rng(9).random((6, 5))))):
        assert (At.toscipy() != Aj.toscipy()).nnz == 0
        np.testing.assert_array_equal(At.todense().numpy(), At.toscipy().toarray())
