"""Kernels K1, K5 and K4 on a CUDA device, against their plain versions.

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
    with pytest.raises(NotImplementedError):
        cs.stencil2d_matvec(c.to(torch.complex64), x.to(torch.complex64),
                            A.row_offsets, A.col_offsets)


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
