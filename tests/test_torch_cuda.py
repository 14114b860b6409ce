"""Kernels K1 (real and complex), K2, K3, K4, K5, K8 and K9 on a CUDA
device, against their plain versions, and the solves that launch them.

Needs an NVIDIA Hopper GPU (the kernels are built for sm_90a) and nvcc;
every test skips without a CUDA device.  Imports no JAX, so it also runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch as kt
from krylov_tpu_torch.ops import cuda_stencil as cs
from krylov_tpu_torch.ops import stencil as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ops(dev):
    a = np.exp(np.random.default_rng(0).standard_normal((33, 50)))
    return [st.poisson_2d(19, 37, device=dev), st.diffusion_2d(a, device=dev),
            st.poisson_3d(5, 6, 40, device=dev)]


def _rand(shape, dev, dtype, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(
        dev, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_matches_plain(dev, dtype, tol):
    for A in _ops(dev):
        c = A.coeffs2d.to(dtype)
        M, ny = A.grid
        h = A.halo
        x = _rand((M, ny), dev, dtype)
        for args in ((), (_rand((h, ny), dev, dtype, 2), _rand((h, ny), dev, dtype, 3))):
            want = cs.stencil2d_matvec_plain(c, x, A.row_offsets, A.col_offsets, *args)
            got = cs.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets, *args)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=tol * float(want.abs().max()))
        xb = _rand((2, M, ny), dev, dtype, 4)
        want = cs.stencil2d_matvec_plain(c, xb, A.row_offsets, A.col_offsets)
        got = cs.stencil2d_matvec(c, xb, A.row_offsets, A.col_offsets)
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


def test_k1_bf16_matches_plain(dev):
    for A in _ops(dev):
        c = A.coeffs2d.to(torch.bfloat16)
        x = _rand(A.grid, dev, torch.bfloat16)
        want = cs.stencil2d_matvec_plain(c, x, A.row_offsets, A.col_offsets)
        got = cs.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-5 * float(want.float().abs().max()))


def test_k1_refuses_what_it_cannot_run(dev):
    A = _ops(dev)[0]
    c, x = A.coeffs2d.float(), _rand(A.grid, dev, torch.float32)
    with pytest.raises(ValueError, match="overlap"):
        cs.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets, out=x)
    with pytest.raises(TypeError):
        cs.stencil2d_matvec(c, x.double(), A.row_offsets, A.col_offsets)
    with pytest.raises(TypeError):  # complex coefficients, real vector
        cs.stencil2d_matvec(c.to(torch.complex64), x, A.row_offsets, A.col_offsets)


def test_k5_k4_match_plain(dev):
    for A in _ops(dev):
        c = A.coeffs2d.float()
        r, p = _rand(A.grid, dev, torch.float32, 5), _rand(A.grid, dev, torch.float32, 6)
        om = torch.tensor(0.7, device=dev)
        got = cs.cg_fused_phase_a_var(om, r, p, c, A.row_offsets, A.col_offsets)
        want = cs.cg_fused_phase_a_var_plain(om, r, p, c, A.row_offsets, A.col_offsets)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))
        y, ap = _rand(A.grid, dev, torch.float32, 7), _rand(A.grid, dev, torch.float32, 8)
        al = torch.tensor(0.3, device=dev)
        got = cs.cg_fused_phase_b(al, y.clone(), r.clone(), p, ap)
        want = cs.cg_fused_phase_b_plain(al, y.clone(), r.clone(), p, ap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))
        with pytest.raises(ValueError, match="float32"):
            cs.cg_fused_phase_a_var(om.double(), r.double(), p.double(), c.double(),
                                    A.row_offsets, A.col_offsets)


def test_solves_launch_the_kernels_and_repeat_bitwise(dev):
    A = st.diffusion_2d(np.exp(np.random.default_rng(9).standard_normal((64, 96)))
                        .astype(np.float32), device=dev)
    b = torch.ones(A.grid, device=dev)
    cs.reset_launches()
    _, info = kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=0.0, atol=0.0,
                    maxiter=20, backend="while_loop")
    assert cs.LAUNCHES["stencil2d_matvec"] >= 20
    runs = []
    for _ in range(2):
        cs.reset_launches()
        _, info = kt.cg_stencil(A, b, tol=0.0, atol=0.0, maxiter=20, fused=True)
        assert cs.LAUNCHES["cg_fused_phase_a_var"] == 20
        assert cs.LAUNCHES["cg_fused_phase_b"] == 20
        runs.append(info)
    np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
    assert torch.equal(runs[0].xk, runs[1].xk)


@pytest.mark.parametrize("cd,xd", [(torch.complex64, torch.complex64),
                                   (torch.float32, torch.complex64),
                                   (torch.complex128, torch.complex128)])
def test_k1_complex_matches_plain(dev, cd, xd):
    tol = 1e-5 if xd == torch.complex64 else 1e-12
    for A in _ops(dev):
        c = A.coeffs2d
        if cd.is_complex:
            c = c + 1j * _rand(c.shape, dev, torch.float64, 11)
        c = c.to(cd)
        x = (_rand(A.grid, dev, torch.float64, 12)
             + 1j * _rand(A.grid, dev, torch.float64, 13)).to(xd)
        got = cs.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets)
        want = cs.stencil2d_matvec_plain(c, x, A.row_offsets, A.col_offsets)
        assert got.dtype == xd
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


def _const_ops():
    nonherm = st.ConstStencilOperator((33, 50), [(0, 0), (1, 0), (0, -1), (1, 2)],
                                      [4.0, -1.5, -0.5, 0.25])
    return [st.poisson_2d_const(19, 37), st.poisson_3d_const(5, 6, 40), nonherm]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)])
def test_k2_matches_plain(dev, dtype, tol):
    rtol = 1e-2 if dtype == torch.bfloat16 else 0.0
    for A in _const_ops():
        M, ny = A.grid
        h = cs.halo_rows([b[0] for b in A.bands])
        x = _rand((M, ny), dev, dtype)
        halos = dict(row0=3, top_halo=_rand((h, ny), dev, dtype, 2),
                     bot_halo=_rand((h, ny), dev, dtype, 3))
        for xx, bands, kw in ((x, A.kernel_bands, {}), (x, A.bands, halos),
                              (_rand((3, M, ny), dev, dtype, 4), A.kernel_bands, {})):
            got = cs.const_stencil2d_matvec(xx, bands, **kw)
            want = cs.const_stencil2d_matvec_plain(xx, bands, **kw)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=tol * float(want.float().abs().max()))
        y = A @ x  # the operator routes through K2 on the card
        assert y.device == x.device and y.dtype == dtype


def test_k2_equals_k1_on_the_laplacian(dev):
    """Summed in grid order, the const Laplacian (K2) and the
    variable-coefficient one (K1) agree bit for bit in f32."""
    for Ac, Av in ((st.poisson_2d_const(70, 300), st.poisson_2d(70, 300, dtype=np.float32,
                                                                 device=dev)),
                   (st.poisson_3d_const(5, 6, 40), st.poisson_3d(5, 6, 40, dtype=np.float32,
                                                                 device=dev))):
        x = _rand(Ac.grid, dev, torch.float32, 9)
        assert torch.equal(Ac @ x, Av @ x)


def test_k3_k8_match_plain(dev):
    om = torch.tensor(0.7, device=dev)
    for A in _const_ops():
        kb = A.kernel_bands
        r, p = _rand(A.grid, dev, torch.float32, 5), _rand(A.grid, dev, torch.float32, 6)
        got = cs.cg_fused_phase_a(om, r, p, kb)
        want = cs.cg_fused_phase_a_plain(om, r, p, kb)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            z, rr = p.to(dtype), r.to(dtype)
            for update in (True, False):
                got = cs.jacobi_sweep_const(0.2, z, rr, kb, update)
                want = cs.jacobi_sweep_const_plain(0.2, z, rr, kb, update)
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=tol * float(want.abs().max()))
        with pytest.raises(ValueError, match="overlap"):
            cs.jacobi_sweep_const(0.2, p, r, kb, out=p)


def test_k9_matches_plain_and_refuses_too_many_bands(dev):
    rng = np.random.default_rng(14)
    pairs = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    ro, co = tuple(q[0] for q in pairs), tuple(q[1] for q in pairs)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        c = torch.from_numpy(rng.standard_normal((25, 37, 45))).to(dev, dtype)
        w = torch.from_numpy(0.1 + rng.random((37, 45))).to(dev, dtype)
        z, r = _rand((37, 45), dev, dtype, 15), _rand((37, 45), dev, dtype, 16)
        for update in (True, False):
            got = cs.jacobi_sweep_var(w, z, r, c, ro, co, update)
            want = cs.jacobi_sweep_var_plain(w, z, r, c, ro, co, update)
            torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))
    c33 = torch.zeros((33, 37, 45), device=dev, dtype=z.dtype)
    with pytest.raises(ValueError, match="band set"):
        cs.jacobi_sweep_var(w, z, r, c33, (0,) * 33, (0,) * 33)


def test_const_and_mg_solves_launch_the_kernels_and_repeat_bitwise(dev):
    A = st.poisson_2d_const(96, 64, device=dev)
    b = torch.ones(A.grid, device=dev)
    runs = []
    for _ in range(2):
        cs.reset_launches()
        _, info = kt.cg_stencil(A, b, tol=0.0, atol=0.0, maxiter=20, fused=True)
        assert cs.LAUNCHES["cg_fused_phase_a"] == cs.LAUNCHES["cg_fused_phase_b"] == 20
        runs.append(info)
    np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
    assert torch.equal(runs[0].xk, runs[1].xk)

    xstar = _rand(A.grid, dev, torch.float32, 17)
    b = A @ xstar
    for op, key in ((A, "jacobi_sweep_const"),
                    (st.diffusion_2d(1.0 + np.random.default_rng(18).random((96, 64)),
                                     dtype=np.float32, device=dev), "jacobi_sweep_var")):
        M = kt.MultigridPreconditioner(op)
        runs = []
        for _ in range(2):
            cs.reset_launches()
            x, info = kt.cg(op, b, M=M, inner=lambda u, v: torch.sum(u * v), tol=1e-5,
                            maxiter=30, backend="while_loop")
            assert info.success and cs.LAUNCHES[key] > 0
            runs.append(info)
        np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
        assert torch.equal(runs[0].xk, runs[1].xk)
