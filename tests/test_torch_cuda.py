"""Kernels K1, K2, K8 and K9 (real and complex), K3 to K7, and the
general-sparsity kernels K10, K11 and K12 on a CUDA device, against their
plain versions, the solves that launch them, and the device rule; the
gradients of K1 and K12 and ``diffable.solve`` on the card, and the other
kernels' refusal of inputs that require a gradient.

Needs an NVIDIA Hopper GPU (the kernels are built for sm_90a) and nvcc;
every test skips without a CUDA device.  Imports no JAX, so it also runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

import krylov_tpu_torch as kt
from krylov_tpu_torch import _driver
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


def _square_bands(h, seed):
    """A seeded const stencil with every offset in [-h, h]^2: 9 bands for
    h = 1, 25 for h = 2 (a Galerkin coarse level's shape)."""
    offs = [(a, b) for a in range(-h, h + 1) for b in range(-h, h + 1)]
    weights = np.random.default_rng(seed).standard_normal(len(offs))
    return offs, list(weights)


def _k2_path_cases():
    """(operator, path its float32 product takes) over the shapes K2's two
    kernels split: row lengths that are and are not multiples of 4, a ragged
    1000 x 1500 grid, 9 and 25 bands, row constraints (3-D), and bands
    farther than the tiled kernel's ring reaches."""
    far = st.ConstStencilOperator((40, 64), [(0, 0), (cs.K2_MAX_HALO + 1, 0), (0, -3)],
                                  [2.0, -1.0, 0.5])
    return [(st.poisson_2d_const(19, 37), "general"),
            (st.poisson_2d_const(70, 300), "tiled"),
            (st.poisson_2d_const(1000, 1500), "tiled"),
            (st.poisson_2d_const(130, 4), "tiled"),
            (st.poisson_3d_const(5, 6, 40), "tiled"),
            (st.poisson_3d_const(5, 6, 42), "general"),
            (st.ConstStencilOperator((33, 50), [(0, 0), (1, 0), (0, -1), (1, 2)],
                                     [4.0, -1.5, -0.5, 0.25]), "general"),
            (st.ConstStencilOperator((67, 132), *_square_bands(1, 11)), "tiled"),
            (st.ConstStencilOperator((67, 132), *_square_bands(2, 12)), "tiled"),
            (st.ConstStencilOperator((67, 131), *_square_bands(2, 12)), "general"),
            (far, "general")]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)])
def test_k2_matches_plain(dev, dtype, tol):
    """Both of K2's kernels against the plain version: float32 at 1e-5 of
    the largest entry (float32 sums of up to 25 terms; the two sides round
    alike), bfloat16 also one bf16 rounding apart.  Only float32 takes the
    tiled kernel, and then only on 16-byte boundaries."""
    rtol = 1e-2 if dtype == torch.bfloat16 else 0.0
    for A, path in _k2_path_cases():
        M, ny = A.grid
        h = cs.halo_rows([b[0] for b in A.bands])
        x = _rand((M, ny), dev, dtype)
        halos = dict(row0=3, top_halo=_rand((h, ny), dev, dtype, 2),
                     bot_halo=_rand((h, ny), dev, dtype, 3))
        # the same grid one element off its allocation's start: never 16-byte aligned
        off = torch.empty(M * ny + 1, dtype=dtype, device=dev)[1:].view(M, ny).copy_(x)
        for xx, bands, kw, aligned in (
                (x, A.kernel_bands, {}, True), (x, A.bands, halos, True),
                (_rand((3, M, ny), dev, dtype, 4), A.kernel_bands, {}, True),
                (off, A.kernel_bands, {}, False)):
            cs.reset_launches()
            got = cs.const_stencil2d_matvec(xx, bands, **kw)
            want = cs.const_stencil2d_matvec_plain(xx, bands, **kw)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=tol * float(want.float().abs().max()))
            took = path if dtype == torch.float32 and aligned else "general"
            assert cs.K2_PATHS == {"tiled": int(took == "tiled"),
                                   "general": int(took == "general")}
            if dtype == torch.float32:  # the two kernels agree bit for bit
                assert torch.equal(got, cs.const_stencil2d_matvec(
                    off if xx is x else xx, bands, **kw))
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
                            maxiter=STEPS, backend="while_loop")
            assert info.success and cs.LAUNCHES[key] > 0
            runs.append(info)
        np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
        assert torch.equal(runs[0].xk, runs[1].xk)


# ---------------------------------------------------------------------------
# complex K2, K8 and K9
# ---------------------------------------------------------------------------


def _crand(shape, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(
        dev, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
def test_k2_k8_complex_match_plain(dev, dtype, tol):
    for A in _const_ops():
        M, ny = A.grid
        h = cs.halo_rows([b[0] for b in A.bands])
        x = _crand((M, ny), dev, dtype, 21)
        halos = dict(row0=3, top_halo=_crand((h, ny), dev, dtype, 22),
                     bot_halo=_crand((h, ny), dev, dtype, 23))
        for xx, bands, kw in ((x, A.kernel_bands, {}), (x, A.bands, halos),
                              (_crand((2, M, ny), dev, dtype, 24), A.kernel_bands, {})):
            got = cs.const_stencil2d_matvec(xx, bands, **kw)
            want = cs.const_stencil2d_matvec_plain(xx, bands, **kw)
            assert got.dtype == dtype
            torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))
        r = _crand((M, ny), dev, dtype, 25)
        for update in (True, False):
            got = cs.jacobi_sweep_const(0.2, x, r, A.kernel_bands, update)
            want = cs.jacobi_sweep_const_plain(0.2, x, r, A.kernel_bands, update)
            torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("cd,xd", [(torch.complex64, torch.complex64),
                                   (torch.float32, torch.complex64),
                                   (torch.complex128, torch.complex128),
                                   (torch.float64, torch.complex128)])
def test_k9_complex_matches_plain(dev, cd, xd):
    tol = 1e-5 if xd == torch.complex64 else 1e-12
    pairs = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    ro, co = tuple(q[0] for q in pairs), tuple(q[1] for q in pairs)
    mk = _crand if cd.is_complex else (lambda s, d, t, seed: _rand(s, d, t, seed))
    c = mk((25, 37, 45), dev, cd, 26)
    w = mk((37, 45), dev, cd, 27)
    z, r = _crand((37, 45), dev, xd, 28), _crand((37, 45), dev, xd, 29)
    for update in (True, False):
        got = cs.jacobi_sweep_var(w, z, r, c, ro, co, update)
        want = cs.jacobi_sweep_var_plain(w, z, r, c, ro, co, update)
        assert got.dtype == xd
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


# ---------------------------------------------------------------------------
# general sparsity: K10, K11, K12 and the solves through as_operator
# ---------------------------------------------------------------------------


def _irregular(n=20000, seed=7):
    """The reference bench's irregular matrix at a small size: 5 to 49
    entries a row, columns within +-512 of the diagonal."""
    import scipy.sparse

    rng = np.random.default_rng(seed)
    counts = rng.integers(5, 50, n)
    rows = np.repeat(np.arange(n), counts)
    cols = np.clip(rows + rng.integers(-512, 513, rows.size), 0, n - 1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _k10_cases():
    """(label, scipy CSR) for the shapes K10's runs must get right: short
    and long rows, the 5-point pattern and its adjoint, empty rows, a row
    longer than a run, one row, a rectangular matrix, and sizes that are no
    multiple of the run or of 4."""
    import scipy.sparse

    rng = np.random.default_rng(61)
    g = 90
    lap = scipy.sparse.diags([-1.0, -1.0, 4.5, -1.0, -1.0], [-g, -1, 0, 1, g],
                             shape=(g * g, g * g), format="csr", dtype=np.float32)
    conv = (lap + scipy.sparse.diags([-0.4, 0.4], [-1, 1], shape=lap.shape,
                                     dtype=np.float32)).tocsr()
    holes = _irregular(n=5001, seed=8).tolil()
    for r in (0, 1, 2, 700, 701, 5000):
        holes[r] = 0
    holes = holes.tocsr()
    holes.eliminate_zeros()
    dense_row = _irregular(n=12001, seed=9).tolil()
    dense_row[6000, ::1] = rng.standard_normal(12001)  # 12001 entries: longer than any run
    dense_row[3, ::2] = 1.0  # 6001 entries, among short rows
    one = scipy.sparse.csr_matrix(rng.standard_normal((1, 7)).astype(np.float32))
    rect = scipy.sparse.random(3001, 777, density=0.02, random_state=5, format="csr",
                               dtype=np.float32)
    return [("irregular", _irregular()), ("5-point", lap), ("5-point adjoint", conv.T.tocsr()),
            ("empty rows", holes), ("dense rows", dense_row.tocsr().astype(np.float32)),
            ("one row", one), ("rectangular", rect), ("tall", rect.T.tocsr()),
            ("all rows empty", scipy.sparse.csr_matrix((50, 9), dtype=np.float32))]


K11_KS = (1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 64)


def _shifted(t, shift):
    """``t`` ``shift`` elements past its allocation's start: off every
    16-byte boundary for ``shift = 1``."""
    out = torch.zeros(t.numel() + shift, dtype=t.dtype, device=t.device)[shift:]
    return out.view(t.shape).copy_(t)


def test_k10_k11_match_plain(dev):
    """K10 and K11 at 1e-5 of the largest entry (float32 sums of up to 12001
    products in another order than the plain version's segment sum; bf16
    values are widened exactly, so the same bound holds), repeated bit for
    bit; with the runs prepared and made on the spot, on 16-byte boundaries
    and off them (K11: the columns, the values and X), K11 at every k from
    one column to two slabs."""
    from krylov_tpu_torch.ops import cuda_spmv as sv

    for label, sp in _k10_cases():
        indptr = torch.from_numpy(sp.indptr.astype(np.int32)).to(dev)
        runs = torch.from_numpy(sv.csr_runs(sp.indptr)).to(dev)
        x = _rand(sp.shape[1], dev, torch.float32, 31)
        for vdt in (torch.float32, torch.bfloat16):
            # the columns and values on a 16-byte boundary, and one element off it
            for shift in (0, 1):
                indices = _shifted(torch.from_numpy(sp.indices.astype(np.int32)).to(dev), shift)
                data = _shifted(torch.from_numpy(sp.data.astype(np.float32)).to(dev, vdt), shift)
                want = sv.csr_matvec_plain(indptr, indices, data, x)
                scale = max(float(want.abs().max()), 1e-30)
                for r in (runs, None):
                    got = sv.csr_matvec(indptr, indices, data, x, r)
                    assert got.dtype == torch.float32 and got.shape == (sp.shape[0],), label
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale, msg=label)
                    assert torch.equal(got, sv.csr_matvec(indptr, indices, data, x, r)), label
                for k in K11_KS:
                    X = _shifted(_rand((sp.shape[1], k), dev, torch.float32, 32 + k), shift)
                    want = sv.csr_matvec_plain(indptr, indices, data, X)
                    scale = max(float(want.abs().max()), 1e-30)
                    for r in (runs, None) if shift == 0 else (None,):
                        got = sv.csr_matmat(indptr, indices, data, X, r)
                        what = f"{label} {vdt} k={k} shift={shift}"
                        assert got.dtype == torch.float32 and got.shape == (sp.shape[0], k), what
                        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale,
                                                   msg=what)
                        assert torch.equal(got, sv.csr_matmat(indptr, indices, data, X, r)), what
    sp = _irregular()
    indptr = torch.from_numpy(sp.indptr.astype(np.int32)).to(dev)
    indices = torch.from_numpy(sp.indices.astype(np.int32)).to(dev)
    data = torch.from_numpy(sp.data).to(dev)
    x = _rand(sp.shape[1], dev, torch.float32, 31)
    X = _rand((sp.shape[1], 3), dev, torch.float32, 33)
    with pytest.raises(ValueError, match="float32"):
        sv.csr_matvec(indptr, indices, data, x.double())
    with pytest.raises(ValueError, match="float32"):
        sv.csr_matmat(indptr, indices, data, X.double())
    for fn, v in ((sv.csr_matvec, x), (sv.csr_matmat, X)):
        with pytest.raises(ValueError, match="runs"):
            fn(indptr, indices, data, v, torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("k", [1, 8, 16, 33])
def test_k11_replays_in_a_cuda_graph(dev, k):
    """K11 captured into a CUDA graph with the runs prepared, as the
    ``while_loop`` driver captures it: the replay writes what the eager
    launch does, bit for bit, and the capture counts one launch."""
    from krylov_tpu_torch.ops import cuda_spmv as sv

    sp = _irregular()
    indptr, indices = (torch.from_numpy(a.astype(np.int32)).to(dev)
                       for a in (sp.indptr, sp.indices))
    data = torch.from_numpy(sp.data).to(dev)
    runs = torch.from_numpy(sv.csr_runs(sp.indptr)).to(dev)
    X = _rand((sp.shape[1], k), dev, torch.float32, 34)
    eager = sv.csr_matmat(indptr, indices, data, X, runs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sv.csr_matmat(indptr, indices, data, X, runs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    sv.reset_launches()
    with torch.cuda.graph(graph):
        Y = sv.csr_matmat(indptr, indices, data, X, runs)
    assert sv.LAUNCHES["csr_matmat"] == 1
    Y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(Y, eager)


def test_pet_operator_adjoint_and_reorder(dev):
    import scipy.sparse

    from krylov_tpu_torch.ops.cuda_spmv import LAUNCHES, PETOperator, reset_launches

    sp = _irregular(n=8000, seed=3)
    x = np.random.default_rng(4).standard_normal(sp.shape[0]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    reset_launches()
    for kw in (dict(with_rmatvec=True), dict(with_rmatvec="lazy"),
               dict(with_rmatvec=True, reorder="rcm")):
        op = PETOperator.from_scipy(sp, device=dev, **kw)
        for got, want in ((op @ xt, sp @ x), (op.rmatvec(xt), sp.T @ x)):
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    assert LAUNCHES["csr_matvec"] == 6
    # a scrambled 2-D Poisson: RCM recovers a banded order
    g = 60
    lap = scipy.sparse.kronsum(scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (g, g)),
                               scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (g, g)))
    perm = np.random.default_rng(5).permutation(g * g)
    scr = lap.tocsr()[perm][:, perm].astype(np.float32)
    op = PETOperator.from_scipy(scr, reorder="rcm", device=dev)
    v = np.random.default_rng(6).standard_normal(g * g).astype(np.float32)
    np.testing.assert_allclose((op @ torch.from_numpy(v).to(dev)).cpu().numpy(), scr @ v,
                               rtol=0, atol=1e-5 * np.abs(scr @ v).max())


# K12's shapes: square blocks of the three detected sizes, rectangles, a row
# that is no whole number of 16-byte pieces in any real type, and tiny blocks
K12_BLOCKS = ((32, 32), (64, 64), (128, 128), (48, 32), (16, 48), (32, 30), (3, 5))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12),
                                       (torch.complex64, 1e-5), (torch.complex128, 1e-12)])
def test_k12_matches_plain(dev, dtype, tol):
    """Both of K12's kernels against the plain einsum, at ``tol`` of the
    largest entry (sums of up to 7 * 128 products in the data's own type, in
    another order than the plain version's), each product repeated bit for
    bit, and each call on the kernel the chooser names."""
    from krylov_tpu_torch.ops import cuda_bsr as cb

    rng = np.random.default_rng(40)
    mk = _crand if dtype.is_complex else (lambda s, d, t, seed: _rand(s, d, t, seed))
    cb.reset_launches()
    expected = {"streamed": 0, "general": 0}
    for R, C in K12_BLOCKS:
        for max_blocks in (1, 3, 7):
            nbrows, nbcols = 6, 5
            data = mk((nbrows * max_blocks, R, C), dev, dtype, R + max_blocks)
            cols = torch.from_numpy(rng.integers(0, nbcols, (nbrows, max_blocks)).astype(
                np.int32)).to(dev)
            for k in (1, 3, 8, 16, 17):
                x = mk((nbcols * C, k), dev, dtype, k)
                got = cb.bsr_spmm(data, cols, x)
                want = cb.bsr_spmm_plain(data, cols, x)
                assert got.dtype == dtype and tuple(got.shape) == (nbrows * R, k)
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=tol * float(want.abs().max()),
                                           msg=f"{R}x{C} blocks={max_blocks} k={k}")
                assert torch.equal(got, cb.bsr_spmm(data, cols, x))
                streamed = cb.k12_streamed(dtype, C, k, [data.data_ptr(), x.data_ptr(), 0])
                expected["streamed" if streamed else "general"] += 2
    assert cb.K12_PATHS == expected and min(expected.values()) > 0
    assert cb.LAUNCHES["bsr_spmm"] == sum(expected.values())


def test_k12_unaligned_views_take_the_general_kernel(dev):
    from krylov_tpu_torch.ops import cuda_bsr as cb

    rng = np.random.default_rng(41)
    data = _rand((12, 32, 32), dev, torch.float32, 5)
    cols = torch.from_numpy(rng.integers(0, 4, (4, 3)).astype(np.int32)).to(dev)
    store = torch.zeros(4 * 32 * 8 + 1, device=dev)
    x = store[1:].view(4 * 32, 8).copy_(_rand((128, 8), dev, torch.float32, 6))
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    cb.reset_launches()
    got = cb.bsr_spmm(data, cols, x)
    assert cb.K12_PATHS == {"streamed": 0, "general": 1}
    aligned = cb.bsr_spmm(data, cols, x.clone())
    assert cb.K12_PATHS == {"streamed": 1, "general": 1}
    want = cb.bsr_spmm_plain(data, cols, x)
    for y in (got, aligned):
        torch.testing.assert_close(y, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_bare_csr_matvec_copies_to_the_host_once(dev):
    """The first bare ``csr_matvec`` with an ``indptr`` tensor cuts the runs
    on the host; the second finds them cached and makes no device-to-host
    copy (PyTorch's sync debug mode raises on any synchronizing call)."""
    from krylov_tpu_torch.ops import cuda_spmv as sv

    sp = _shifted_poisson_f32(64)
    indptr, indices, data = (torch.from_numpy(a).to(dev) for a in (
        sp.indptr.astype(np.int32), sp.indices.astype(np.int32), sp.data))
    x = _rand(sp.shape[1], dev, torch.float32, 7)
    first = sv.csr_matvec(indptr, indices, data, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = sv.csr_matvec(indptr, indices, data, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, second)
    want = sv.csr_matvec_plain(indptr, indices, data, x)
    torch.testing.assert_close(first, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_stationary_path_on_the_card(dev):
    """The stationary solvers keep everything on the card: ``jacobi`` on a
    grid stencil launches K1 once a step, the grid sweeps and the
    level-scheduled sweeps agree with float64 CPU runs of the same code."""
    A = st.poisson_2d(64, 48, dtype=np.float32, device=dev)
    b = _rand(64 * 48, dev, torch.float32, 9)
    cs.reset_launches()
    _, info = kt.jacobi(A, b, omega=0.8, maxiter=10, tol=1e-30, backend="while_loop")
    assert info.numsteps == 10 and cs.LAUNCHES["stencil2d_matvec"] == 10
    A64 = st.poisson_2d(64, 48, device="cpu")
    for name, kw in (("jacobi", dict(omega=0.8)), ("gauss_seidel", {}),
                     ("sor", dict(omega=1.3)), ("ssor", dict(omega=1.3))):
        _, info = getattr(kt, name)(A, b, maxiter=5, tol=1e-30, **kw)
        _, ref = getattr(kt, name)(A64, b.double().cpu(), maxiter=5, tol=1e-30, **kw)
        assert info.xk.device == dev
        np.testing.assert_allclose(info.resnorms, ref.resnorms, rtol=1e-4)
    M = kt.SSORSmoother(A, omega=1.2)
    assert M.device == dev and (M @ b).device == dev
    lo, hi = kt.utils.estimate_spectrum(A)
    assert 0 < lo < hi < 8.5
    Mc = kt.ChebyshevPreconditioner(A, (lo, hi), degree=4)
    cs.reset_launches()
    assert (Mc @ b).device == dev and cs.LAUNCHES["stencil2d_matvec"] == 4


def _shifted_poisson_f32(g, shift=0.5):
    import scipy.sparse

    n = g * g
    return scipy.sparse.diags([-1.0, -1.0, 4.0 + shift, -1.0, -1.0], [-g, -1, 0, 1, g],
                              shape=(n, n), format="csr", dtype=np.float32)


def test_sparse_solves_route_to_the_kernels_and_repeat_bitwise(dev):
    from krylov_tpu_torch.ops import cuda_bsr as cb
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops.cuda_spmv import PETOperator

    sp = _shifted_poisson_f32(128)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(sp.shape[0])).to(
        dev, torch.float32)
    assert isinstance(kt.as_operator(sp, dev), PETOperator)
    dinv = kt.DiagonalOperator(torch.from_numpy(1.0 / sp.diagonal()).to(dev))
    for solve in (lambda: kt.bicgstab(sp, b, Ml=dinv, tol=1e-4, maxiter=200,
                                      backend="while_loop"),
                  lambda: kt.gmres(sp, b, ortho="mgs", tol=1e-4, maxiter=120,
                                   backend="while_loop")):
        runs = []
        for _ in range(2):
            sv.reset_launches()
            _, info = solve()
            assert info.success and sv.LAUNCHES["csr_matvec"] > info.numsteps
            runs.append(info)
        np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
        assert torch.equal(runs[0].xk, runs[1].xk)
    # block-structured SPD input goes to BSR, and its blocked solve to K12
    import scipy.sparse

    blk = scipy.sparse.random(256, 256, density=0.5, random_state=9, dtype=np.float64)
    dense = blk.toarray()
    spd = scipy.sparse.csr_matrix(np.kron(np.eye(8), dense @ dense.T + 256 * np.eye(256)))
    B = torch.ones((spd.shape[0], 4), device=dev, dtype=torch.float64)
    cb.reset_launches()
    _, info = kt.cg(spd, B, tol=1e-8, maxiter=100, backend="while_loop")
    assert info.success and cb.LAUNCHES["bsr_spmm"] > info.numsteps


# --- K6 / K7, fused Jacobi CG, the solver family and the device rule ---------


def _jacobi_cases(dev):
    """(label, planes, row offsets, col offsets) at the shapes chip_smoke's
    phase 7a checks, smaller: five bands on a ragged grid, 9 and 25 bands."""
    rng = np.random.default_rng(20)
    A = st.diffusion_2d(np.exp(rng.standard_normal((250, 375))).astype(np.float32),
                        device=dev)
    pairs = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    c25 = _rand((25, 67, 131), dev, torch.float32, 21)
    nine = [k for k, (a, b) in enumerate(pairs) if abs(a) <= 1 and abs(b) <= 1]
    ro, co = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    return [("5 bands (250, 375)", A.coeffs2d, A.row_offsets, A.col_offsets),
            ("9 bands", c25[nine].contiguous(), tuple(ro[k] for k in nine),
             tuple(co[k] for k in nine)),
            ("25 bands", c25, ro, co)]


def test_k6_k7_match_plain_and_check_operands(dev):
    om, al = torch.tensor(0.7, device=dev), torch.tensor(0.3, device=dev)
    for label, c, ro, co in _jacobi_cases(dev):
        shape = tuple(c.shape[1:])
        r, p, y, ap = (_rand(shape, dev, torch.float32, s) for s in (22, 23, 24, 25))
        dinv = 0.1 + torch.rand(shape, device=dev, generator=torch.Generator(dev).manual_seed(1))
        got = cs.cg_fused_phase_a_var_jac(om, r, p, c, dinv, ro, co)
        want = cs.cg_fused_phase_a_var_jac_plain(om, r, p, c, dinv, ro, co)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()),
                                       msg=lambda m: f"K6 {label}: {m}")
        got = cs.cg_fused_phase_b_jac(al, y.clone(), r.clone(), p, ap, dinv)
        want = cs.cg_fused_phase_b_jac_plain(al, y.clone(), r.clone(), p, ap, dinv)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()),
                                       msg=lambda m: f"K7 {label}: {m}")
    # out must be neither r nor p (other blocks still read them), nor dinv
    for bad in (r, p, dinv):
        with pytest.raises(ValueError, match="overlap"):
            cs.cg_fused_phase_a_var_jac(om, r, p, c, dinv, ro, co,
                                        out=(bad, torch.empty_like(r)))
    with pytest.raises(ValueError, match="overlap"):
        cs.cg_fused_phase_b_jac(al, y, r, p, ap, r)
    with pytest.raises(ValueError, match="float32"):
        cs.cg_fused_phase_b_jac(al, y.double(), r.double(), p.double(), ap.double(),
                                dinv.double())
    with pytest.raises(ValueError, match="dinv"):
        cs.cg_fused_phase_a_var_jac(om, r, p, c, dinv[:-1], ro, co)


def test_fused_jacobi_solve_launches_k6_k7_and_repeats_bitwise(dev):
    A = st.diffusion_2d(np.exp(np.random.default_rng(9).standard_normal((64, 96)))
                        .astype(np.float32), device=dev)
    b = torch.ones(A.grid, device=dev)
    runs = []
    for _ in range(2):
        cs.reset_launches()
        _, info = kt.cg_stencil(A, b, tol=0.0, atol=0.0, maxiter=20, fused=True, M="jacobi")
        assert cs.LAUNCHES["cg_fused_phase_a_var_jac"] == 20
        assert cs.LAUNCHES["cg_fused_phase_b_jac"] == 20
        assert cs.LAUNCHES["cg_fused_phase_a_var"] == cs.LAUNCHES["cg_fused_phase_b"] == 0
        runs.append(info)
    np.testing.assert_array_equal(runs[0].resnorms, runs[1].resnorms)
    assert torch.equal(runs[0].xk, runs[1].xk)
    _, unfused = kt.cg_stencil(A, b, tol=0.0, atol=0.0, maxiter=20, fused=False, M="jacobi")
    np.testing.assert_allclose(runs[0].resnorms, unfused.resnorms, rtol=2e-3)


def test_twosided_solves_count_the_adjoint_launches(dev):
    import scipy.sparse

    from krylov_tpu_torch.ops.cuda_spmv import LAUNCHES, reset_launches

    n = 128
    sp = scipy.sparse.diags([-1.0, -1.0, 4.5, -1.0, -1.0], [-n, -1, 0, 1, n],
                            shape=(n * n, n * n), format="csr", dtype=np.float32)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n * n)
                         .astype(np.float32)).to(dev)
    for solver in (kt.qmr, kt.bicg):
        reset_launches()
        x, info = solver(sp, b, tol=1e-4, maxiter=200, backend="while_loop")
        assert info.success and x.is_cuda
        assert LAUNCHES["csr_matvec"] >= 2 * info.numsteps  # forward and adjoint
        r = b.double().cpu().numpy() - sp.astype(np.float64) @ x.double().cpu().numpy()
        assert np.linalg.norm(r) <= 2e-4 * float(torch.linalg.norm(b))


def test_inputs_without_a_device_land_on_the_card(dev):
    """Nothing names a device: the factory, the numpy right-hand side and
    the solve all land on the CUDA device."""
    kt.set_default_device(None)
    A = st.poisson_2d(32, dtype=np.float32)
    assert A.coeffs2d.is_cuda
    cs.reset_launches()
    x, info = kt.cg_stencil(A, np.ones(A.grid, np.float32), tol=0.0, atol=0.0, maxiter=5,
                            fused=True)
    assert info.xk.is_cuda and cs.LAUNCHES["cg_fused_phase_a_var"] == 5
    with pytest.raises((RuntimeError, ValueError)):
        kt.cg_stencil(A, torch.ones(A.grid))  # a CPU tensor is not moved to the card


# --- the sparse preconditioners: AMG on K10/K11 levels, ILU, block Jacobi ----


def _level_launches(M):
    """K10 launches of one V(s, s) cycle with a smoothed prolongator: on a
    PETOperator level, the smoothing (Jacobi: s - 1 products from zero and s
    after; Chebyshev: s and s + 1), the residual and two in the transfers;
    on a PETOperator prolongator two (forward and adjoint)."""
    from krylov_tpu_torch.ops.cuda_spmv import PETOperator

    per_level = 2 * M.smooth + (2 if M.smoother == "jacobi" else 4)
    return sum(per_level * isinstance(op, PETOperator) + 2 * isinstance(p, PETOperator)
               for op, p in zip(M._ops, M._phats))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_amg_cycle_on_the_kernels_matches_plain_levels(dev, smoother):
    """The same float32 hierarchy twice: its large levels on K10/K11
    (``PETOperator``) and on plain CSR levels; one V-cycle of each agrees at
    the float32 band, and the kernel launches are counted."""
    from unittest import mock

    from krylov_tpu_torch import _operators
    from krylov_tpu_torch.ops import _native
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops.sparse import CSROperator

    sp = _shifted_poisson_f32(256, shift=0.0)
    _native.reset_native_paths()
    M = kt.AMGPreconditioner.from_scipy(sp, dtype=np.float32, smoother=smoother, device=dev)
    assert _native.NATIVE_PATHS["amg_pairwise_labels"]["numpy"] == 0
    with mock.patch.object(_operators, "_pet_device", lambda device: False):
        plain = kt.AMGPreconditioner.from_scipy(sp, dtype=np.float32, smoother=smoother,
                                                device=dev)
    assert all(isinstance(op, CSROperator) for op in plain._ops + plain._phats)
    assert M.level_sizes == plain.level_sizes and M.device == dev
    expected = _level_launches(M)
    assert expected >= 8  # at least the fine level and its prolongator
    r = _rand(sp.shape[0], dev, torch.float32, 30)
    sv.reset_launches()
    z = M @ r
    torch.cuda.synchronize()
    assert sv.LAUNCHES["csr_matvec"] == expected and sv.LAUNCHES["csr_matmat"] == 0
    want = plain @ r
    torch.testing.assert_close(z, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    R = _rand((sp.shape[0], 4), dev, torch.float32, 31)
    sv.reset_launches()
    Z = M @ R
    torch.cuda.synchronize()
    assert sv.LAUNCHES["csr_matmat"] == expected and sv.LAUNCHES["csr_matvec"] == 0
    want = plain @ R
    torch.testing.assert_close(Z, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    b = r.double().cpu().numpy()
    x, info = kt.cg(sp, r, M=M, tol=1e-5, maxiter=60, backend="while_loop")
    assert info.success and x.device == dev and info.numsteps <= 15
    res = b - sp.astype(np.float64) @ x.double().cpu().numpy()
    assert np.linalg.norm(res) <= 1e-4 * np.linalg.norm(b)


def test_ilu_and_block_jacobi_on_the_card_match_the_cpu(dev):
    """One application of ILU(0) (both sweeps), of its adjoint and of block
    Jacobi on the card against the same preconditioner on the CPU."""
    import scipy.sparse

    g = 256
    n = g * g
    # the convected shifted Poisson on a true grid: no coupling across grid
    # rows, so ILU(0)'s levels are the wavefront (2 g - 1), not a chain of n
    side = np.ones(n - 1)
    side[g - 1::g] = 0.0
    A = scipy.sparse.diags([-np.ones(n - g), -1.4 * side, 4.5 * np.ones(n), -0.6 * side,
                            -np.ones(n - g)], [-g, -1, 0, 1, g], format="csr", dtype=np.float32)
    r = _rand(g * g, dev, torch.float32, 32)
    R = _rand((g * g, 3), dev, torch.float32, 33)
    for build in (lambda d: kt.ILUPreconditioner.from_scipy(A, with_rmatvec=True, device=d),
                  lambda d: kt.BlockJacobiPreconditioner.from_scipy(A, block=64, device=d),
                  lambda d: kt.BlockJacobiPreconditioner.from_scipy(A, block=g, device=d)):
        M, Mc = build(dev), build("cpu")
        assert M.device == dev and M.dtype == torch.float32
        for v in (r, R):
            for got, want in ((M @ v, Mc @ v.cpu()), (M.rmatvec(v), Mc.rmatvec(v.cpu()))):
                assert got.device == dev and got.shape == v.shape
                torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                           atol=1e-5 * float(want.abs().max()))


def test_k1_gradient_matches_plain(dev):
    """K1's Function on the card (the coefficient gradient in torch, the x
    gradient by K1 on the adjoint planes) against autograd through the
    plain version on the card, real and complex, batched and with halos."""
    A = _ops(dev)[1]
    ro, co = A.row_offsets, A.col_offsets
    M, ny = A.grid
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5),
                       (torch.complex128, 1e-12)):
        c = A.coeffs2d.to(dtype)
        for shape, halos in (((M, ny), ()), ((3, M, ny), ()),
                             ((M, ny), (_rand((1, ny), dev, dtype, 5),
                                        _rand((1, ny), dev, dtype, 6)))):
            x = _rand(shape, dev, dtype, 7)
            w = _rand(shape, dev, dtype, 8)
            grads = []
            for fn in (cs.stencil2d_matvec, cs.stencil2d_matvec_plain):
                leaves = [t.clone().requires_grad_() for t in (c, x, *halos)]
                y = fn(leaves[0], leaves[1], ro, co, *leaves[2:])
                (y * w.conj()).real.sum().backward()
                grads.append([t.grad for t in leaves])
            for got, want in zip(*grads):
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=tol * float(want.abs().max()))


def test_k12_gradient_matches_plain_and_refuses_x(dev):
    """K12's data gradient on the card against autograd through the plain
    version; a gradient to X through K12 on the card raises."""
    from krylov_tpu_torch.ops import cuda_bsr as bs

    rng = np.random.default_rng(40)
    nbrows, max_blocks, R, C, k = 64, 3, 32, 32, 8
    data = _rand((nbrows * max_blocks, R, C), dev, torch.float32, 41)
    cols = torch.from_numpy(rng.integers(0, nbrows, (nbrows, max_blocks)).astype(np.int32)).to(dev)
    x = _rand((nbrows * C, k), dev, torch.float32, 42)
    w = _rand((nbrows * R, k), dev, torch.float32, 43)
    grads = []
    for fn in (bs.bsr_spmm, bs.bsr_spmm_plain):
        d = data.clone().requires_grad_()
        bs.reset_launches()
        (fn(d, cols, x) * w).sum().backward()
        grads.append(d.grad)
    assert bs.LAUNCHES["bsr_spmm"] == 0  # the plain run, last, launches nothing
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-5 * float(grads[1].abs().max()))
    with pytest.raises(NotImplementedError, match="diffable.solve"):
        bs.bsr_spmm(data, cols, x.clone().requires_grad_())


def test_kernels_without_a_gradient_refuse_grad_inputs(dev):
    """K2 and K10 have no backward: on the card an input that requires a
    gradient raises in grad mode, and runs under no_grad."""
    import scipy.sparse

    from krylov_tpu_torch.ops import cuda_spmv as sv

    A = kt.poisson_2d_const(64, 64, device=dev)
    x = _rand(A.grid, dev, torch.float32, 44).requires_grad_()
    with pytest.raises(TypeError, match="no gradient"):
        cs.const_stencil2d_matvec(x, A.kernel_bands)
    with torch.no_grad():
        cs.const_stencil2d_matvec(x, A.kernel_bands)
    sp = scipy.sparse.random(300, 300, density=0.05, random_state=2, format="csr",
                             dtype=np.float32)
    indptr, indices, data = (torch.from_numpy(a).to(dev) for a in (
        sp.indptr.astype(np.int32), sp.indices.astype(np.int32), sp.data))
    v = _rand(300, dev, torch.float32, 45)
    with pytest.raises(TypeError, match="no gradient"):
        sv.csr_matvec(indptr, indices, data.requires_grad_(), v)
    with pytest.raises(TypeError, match="no gradient"):
        sv.csr_matvec(indptr, indices, data.detach(), v.requires_grad_())


def test_diffable_solve_on_the_card(dev):
    """diffable.solve through K1 (forward, adjoint, coefficient VJP) on the
    card equals the same solve on the CPU in float64."""
    from krylov_tpu_torch import diffable

    a = np.exp(np.random.default_rng(46).standard_normal((24, 32)))
    b0 = np.random.default_rng(47).standard_normal(24 * 32)
    out = []
    for d in (dev, torch.device("cpu")):
        A = st.diffusion_2d(a, device=d)
        A.coeffs2d.requires_grad_()
        b = torch.from_numpy(b0).to(d).requires_grad_()
        cs.reset_launches()
        x = diffable.solve(A, b, tol=1e-12, maxiter=2000)
        torch.sin(x).sum().backward()
        out.append((x.detach().cpu(), b.grad.cpu(), A.coeffs2d.grad.cpu()))
        if d.type == "cuda":
            assert cs.LAUNCHES["stencil2d_matvec"] > 0
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-10 * float(want.abs().max()))


def test_diffable_bsr_default_leaves_on_the_card(dev):
    """The default leaves of a BSROperator on the card: K12 forward and in
    the parameter VJP (its data gradient), equal to the same solve on the
    CPU in float64."""
    import scipy.sparse

    from krylov_tpu_torch import diffable
    from krylov_tpu_torch.ops import cuda_bsr as bs

    rng = np.random.default_rng(48)
    nb, R = 6, 32
    pattern = np.kron(np.eye(nb) + np.eye(nb, k=1) + np.eye(nb, k=-1), np.ones((R, R)))
    half = pattern * rng.standard_normal(pattern.shape)
    dense = half + half.T + 4 * R * np.eye(nb * R)
    sp = scipy.sparse.csr_matrix(dense)
    b0 = rng.standard_normal(nb * R)
    out = []
    for d in (dev, torch.device("cpu")):
        A = kt.ops.BSROperator.from_scipy(sp, blocksize=(R, R), device=d)
        A.data.requires_grad_()
        b = torch.from_numpy(b0).to(d).requires_grad_()
        bs.reset_launches()
        x = diffable.solve(A, b, tol=1e-12, maxiter=200)
        torch.sin(x).sum().backward()
        out.append((x.detach().cpu(), b.grad.cpu(), A.data.grad.cpu()))
        if d.type == "cuda":
            assert bs.LAUNCHES["bsr_spmm"] > 0
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-10 * float(want.abs().max()))


STEPS = 10  # fixed steps of the sharded solves


def _sharded_cases(dev):
    """(label, operator on the CPU, its twin on the card, b, kernel, solver
    keywords): the grid (K1), PET (K10) and BSR (K12) paths in float32."""
    import scipy.sparse

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.ops import cuda_spmv as sv

    n = 64
    sp = scipy.sparse.diags([-1.0, -1.0, 4.5, -1.0, -1.0], [-n, -1, 0, 1, n],
                            shape=(n * n, n * n), format="csr", dtype=np.float32)
    rng = np.random.default_rng(50)
    nb, R = 16, 32
    pattern = np.kron(np.eye(nb) + np.eye(nb, k=1) + np.eye(nb, k=-1), np.ones((R, R)))
    half = pattern * rng.standard_normal(pattern.shape)
    blk = scipy.sparse.csr_matrix((half + half.T + 4 * R * np.eye(nb * R)).astype(np.float32))
    return [
        ("grid", st.poisson_2d(n, dtype=np.float32, device="cpu"),
         st.poisson_2d(n, dtype=np.float32, device=dev), np.ones((n, n), np.float32),
         "stencil2d_matvec"),
        ("pet", lambda ranks: parallel.partition_pet(sp, ranks),
         sv.PETOperator.from_scipy(sp, device=dev), np.ones(n * n, np.float32), "csr_matvec"),
        ("bsr", kt.ops.BSROperator.from_scipy(blk, blocksize=(R, R), device="cpu"),
         kt.ops.BSROperator.from_scipy(blk, blocksize=(R, R), device=dev),
         np.ones(nb * R, np.float32), "bsr_spmm"),
    ]


def _single(A, b, dev):
    b = torch.as_tensor(b).to(dev)
    kw = {"inner": lambda u, v: torch.sum(u * v)} if b.ndim == 2 else {}
    return kt.cg(A, b, tol=0.0, atol=0.0, maxiter=STEPS, backend="while_loop", **kw)[1]


def _held(steps, hist, ref):
    """f32 sharded histories against single-device ones: the reference's
    band for sharded runs (rtol 2e-3) at equal steps, over the steps above
    1e-4 of the first residual (below it two float32 histories part)."""
    assert steps == ref.numsteps
    live = ref.resnorms >= 1e-4 * ref.resnorms[0]
    assert live.sum() >= 3
    np.testing.assert_allclose(hist[live], ref.resnorms[live], rtol=2e-3)


def test_sharded_solve_on_one_nccl_rank(dev):
    """A world of one rank on NCCL through ``sharded_solve`` on the grid,
    PET and BSR paths, against the single-device solve on the card."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.ops import cuda_bsr, cuda_spmv
    from krylov_tpu_torch.parallel import mesh as pm

    mesh = parallel.make_mesh(device=dev)
    try:
        assert "nccl" in dist.get_backend() and not mesh.staged
        for label, A, A_dev, b, kernel in _sharded_cases(dev):
            A = A(1) if callable(A) else A
            for mod in (cs, cuda_spmv, cuda_bsr):
                mod.reset_launches()
            pm.reset_counts()
            _, info = parallel.sharded_solve(kt.cg, A, b, mesh=mesh, tol=0.0, atol=0.0,
                                             maxiter=STEPS)
            launched = {**cs.LAUNCHES, **cuda_spmv.LAUNCHES, **cuda_bsr.LAUNCHES}[kernel]
            assert launched >= STEPS and sum(pm.STAGED.values()) == 0, label
            assert info.xk.device == dev
            _held(info.numsteps, info.resnorms, _single(A_dev, b, dev))
    finally:
        dist.destroy_process_group()


def test_sharded_solve_two_gloo_ranks_on_one_card(dev):
    """Two ranks sharing the card under gloo: every transfer staged through
    the host (``mesh.STAGED``), the kernels launched on each rank, the
    single-device trajectory."""
    from krylov_tpu_torch.parallel import _spawn

    with _spawn.SPMDPool(2, backend="gloo", device="cuda", timeout=300.0) as pool:
        for label, A, A_dev, b, kernel in _sharded_cases(dev):
            A = A(2) if callable(A) else A
            res = pool.run(_spawn.solve_job, kt.cg, A, b, tol=0.0, atol=0.0, maxiter=STEPS)
            for per in res["per_rank"]:
                assert sum(per["staged"].values()) > 0, label
                assert per["launches"].get(kernel, 0) >= STEPS, label
            _held(res["info"][1], res["info"][2], _single(A_dev, b, dev))


def test_sharded_capture_on_one_nccl_rank(dev):
    """A world of one NCCL rank, ``cg`` at 256^2 with a capture forced:
    the mesh launches no collective, the rank captures as one device
    does, bit-equal to its host-stepped run with the same launches."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.parallel import mesh as pm

    A = st.poisson_2d(256, dtype=np.float32, device="cpu")
    b = torch.ones(A.grid, dtype=torch.float32)
    mesh = parallel.make_mesh(device=dev)
    got = {}
    try:
        assert "nccl" in dist.get_backend() and mesh.alone()
        for route, ctx in (("host", _driver._host_stepped), ("capture", lambda: (
                _driver._capture_at(after=3, steps=4, replays=4)))):
            cs.reset_launches()
            pm.reset_counts()
            _driver.reset_counts()
            with ctx():
                _, info = parallel.sharded_solve(kt.cg, A, b, mesh=mesh, tol=0.0, atol=0.0,
                                                 maxiter=STEPS)
            torch.cuda.synchronize()
            assert not any(pm.COUNTS.values()), pm.COUNTS
            got[route] = (info, dict(cs.LAUNCHES), dict(_driver.COUNTS))
    finally:
        dist.destroy_process_group()
    (h, n_h, c_h), (g, n_g, c_g) = got["host"], got["capture"]
    assert c_h["host_stepped"] == 1 and c_g["captures"] == 1 and c_g["graph_steps"] > 0, c_g
    assert c_g["meetings"] == 0 and n_g == n_h and n_h["stencil2d_matvec"] >= STEPS
    assert g.numsteps == h.numsteps == STEPS and torch.equal(g.xk, h.xk)
    np.testing.assert_array_equal(g.resnorms, h.resnorms)


def test_a_built_solver_keeps_its_graph_on_one_nccl_rank(dev):
    """``make_sharded_solver`` on a world of one NCCL rank, ``cg_pipelined``
    at 256^2 past its replacement with a capture forced: the first run
    captures the graph the solver keeps, the later two replay it from step
    0 with no host step, each run bit-equal to its host-stepped run with
    the same launches, and once the solver is gone its graph, pool and
    buffers are given back."""
    import gc

    import torch.distributed as dist

    from krylov_tpu_torch import parallel

    A = st.poisson_2d(256, dtype=np.float32, device="cpu")
    rng = np.random.default_rng(7)
    bs = [torch.from_numpy(rng.standard_normal(A.grid).astype(np.float32)).to(dev)
          for _ in range(3)]
    kw = dict(tol=1e-5, maxiter=3 * STEPS, replace_every=STEPS)
    mesh = parallel.make_mesh(device=dev)
    try:
        host = parallel.make_sharded_solver(kt.cg_pipelined, A, mesh=mesh, **kw)
        cs.reset_launches()
        with _driver._host_stepped():
            want = [host(b)[1] for b in bs]
        n_host = dict(cs.LAUNCHES)
        with _driver._capture_at(after=3, steps=4, replays=4):
            host(bs[0])  # a first kept graph: the capture streams' own workspaces
        del host
        gc.collect()  # what stays from here on: the inputs and the host-stepped results
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        run = parallel.make_sharded_solver(kt.cg_pipelined, A, mesh=mesh, **kw)
        cs.reset_launches()
        _driver.reset_counts()
        kept = []
        with _driver._capture_at(after=3, steps=4, replays=4):
            for b, w in zip(bs, want):
                _, info = run(b)
                kept.append(_driver.LAST_GRAPH["kept"])
                assert info.numsteps == w.numsteps and torch.equal(info.xk, w.xk)
                np.testing.assert_array_equal(info.resnorms, w.resnorms)
        torch.cuda.synchronize()
        c = dict(_driver.COUNTS)
        assert kept == ["captured", "replayed", "replayed"], kept
        assert c["captures"] == 1 and c["kept_runs"] == 2 and c["host_steps"] == 3, c
        assert dict(cs.LAUNCHES) == n_host and n_host["stencil2d_matvec"] > 0
        del run, info
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() == allocated
        assert torch.cuda.memory_reserved() == reserved
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("solver", ["cg", "cg_pipelined", "cg_block"])
def test_sharded_capture_on_four_nccl_ranks(dev, solver):
    """Four NCCL ranks, one a GPU, on the grid with a capture forced
    (``cg_pipelined`` and ``cg_block`` past their periodic replacement):
    with ``parallel.solve.nccl_graphs()`` the ranks capture their
    collectives with the kernels, none two conditional levels deep, else
    every rank runs the host-stepped loop; either way each is bit-equal to
    its host-stepped run with the same collectives."""
    from krylov_tpu_torch.parallel import _spawn, solve

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs")
    A = st.poisson_2d(256, dtype=np.float32, device="cpu")
    b = np.ones(A.grid, np.float32)
    kw = dict(tol=0.0, atol=0.0, maxiter=STEPS)
    if solver != "cg":
        kw.update(maxiter=3 * STEPS, replace_every=STEPS)
    if solver == "cg_block":
        b = np.random.default_rng(5).standard_normal(A.grid + (4,)).astype(np.float32)
    with _spawn.SPMDPool(4, backend="nccl", device="cuda", timeout=300.0) as pool:
        res = pool.run(_spawn.graph_job, getattr(kt, solver), A, b, route=("capture", 3, 4, 4),
                       **kw)
    assert res["error"] is None, res["error"]
    (x_h, x_g), (i_h, i_g) = res["x"], res["info"]
    np.testing.assert_array_equal(x_g, x_h)
    np.testing.assert_array_equal(i_g[2], i_h[2])
    for p in res["per_rank"]:
        assert p["collectives"][0] == p["collectives"][1] and p["collectives"][1]["exchange"]
        assert p["launches"][0] == p["launches"][1]
        if solve.nccl_graphs():
            assert p["driver"]["captures"] == 1 and p["driver"]["graph_steps"] > 0, p["driver"]
            # the host steps before the capture at the top, the captured ones an IF deep
            assert {path for _, path in p["nesting"]} == {(), ("if",)}, p["nesting"]
        else:
            assert p["driver"]["host_stepped"] == 1 and p["driver"]["captures"] == 0, p["driver"]


def _distributed_preconditioner_cases():
    """``(label, A, b, sharded_solve keywords, kernels)`` on one rank: the
    distributed AMG with the PET fine level (K10 on the slab, both
    transfers and the tail), the block-Jacobi partition over the PET route,
    the sharded geometric cycle on the const stencil (K2 smoothing, K8 in
    the gathered coarse V-cycle) and the Galerkin cycle (K1).  The
    preconditioned solves stop at 1e-4 (these float32 problems stagnate near
    1e-5 of the first residual); block Jacobi, which needs hundreds of steps
    here, runs 50 fixed ones."""
    from krylov_tpu_torch import parallel

    sp = _shifted_poisson_f32(256, shift=0.0)
    b = np.ones(sp.shape[0], np.float32)
    X, Y = np.meshgrid(np.linspace(0, 1, 256), np.linspace(0, 1, 256), indexing="ij")
    field = (1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)).astype(np.float32)
    grid_b = np.ones((256, 256), np.float32)
    stop = dict(tol=1e-4, maxiter=300)
    return [
        ("partition_amg", parallel.partition_pet(sp, 1), b,
         dict(M_partition=parallel.partition_amg(sp, 1, dtype=np.float32), **stop),
         ["csr_matvec"]),
        ("partition_block_jacobi", parallel.partition_pet(sp, 1), b,
         dict(M_partition=parallel.partition_block_jacobi(sp, 1, block=64), tol=0.0, atol=0.0,
              maxiter=50), ["csr_matvec"]),
        ("multigrid_factory, const", st.poisson_2d_const(256, dtype=np.float32, device="cpu"),
         grid_b, dict(M_factory=kt.multigrid_factory(), **stop),
         ["const_stencil2d_matvec", "jacobi_sweep_const"]),
        ("multigrid_factory, Galerkin", st.diffusion_2d(field, device="cpu"), grid_b,
         dict(M_factory=kt.multigrid_factory(), **stop), ["stencil2d_matvec"]),
    ]


def test_distributed_preconditioners_on_one_nccl_rank(dev):
    """``ShardedAMG``, the block-Jacobi partition and
    ``ShardedMultigridPreconditioner`` / ``ShardedGalerkinMultigrid`` on a
    world of one NCCL rank: each launches its kernels, converges, and two
    solves repeat bit for bit (no float atomics on these paths)."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.ops import cuda_spmv

    mesh = parallel.make_mesh(device=dev)
    try:
        for label, A, b, kw, kernels in _distributed_preconditioner_cases():
            infos = []
            for _ in range(2):
                cs.reset_launches()
                cuda_spmv.reset_launches()
                _, info = parallel.sharded_solve(kt.cg, A, b, mesh=mesh, **kw)
                launched = {**cs.LAUNCHES, **cuda_spmv.LAUNCHES}
                assert all(launched[k] > 0 for k in kernels), (label, launched)
                assert info.xk.device == dev and torch.isfinite(info.xk).all(), label
                assert info.success or kw["tol"] == 0.0, label
                infos.append(info)
            assert infos[0].numsteps == infos[1].numsteps, label
            np.testing.assert_array_equal(infos[0].resnorms, infos[1].resnorms)
            assert torch.equal(infos[0].xk, infos[1].xk), label
    finally:
        dist.destroy_process_group()


# --- the while_loop graph route: captured CUDA graphs with conditional steps ---


def _graph_cases(dev):
    """``{label: solve}`` of every solver and preconditioner the graph route
    takes, small: a grid stencil (K1), the const stencil (K2, fused K3/K4,
    the MG cycle's K8), the lognormal field's fused K5/K4 and K6/K7, the
    shifted Poisson CSR on the PET route (K10 forward and adjoint), its
    unshifted twin under AMG, ILU(0), block Jacobi and Chebyshev, an
    ``(N, 8)`` b (K11), the block-structured SPD matrix (K12), a bfloat16
    PET operator and complex Hermitian solves."""
    import scipy.sparse

    from krylov_tpu_torch.ops.cuda_spmv import PETOperator

    rng = np.random.default_rng(40)
    A = st.diffusion_2d(np.exp(rng.standard_normal((64, 96))).astype(np.float32), device=dev)
    Ac = st.poisson_2d_const(96, 64, device=dev)
    bg, bc = torch.ones(A.grid, device=dev), Ac @ _rand(Ac.grid, dev, torch.float32, 41)
    grid_inner = lambda u, v: torch.sum(u * v)  # noqa: E731
    sp, lap = _shifted_poisson_f32(128), _shifted_poisson_f32(128, shift=0.0)
    n = sp.shape[0]
    b = _rand(n, dev, torch.float32, 42)
    B8 = _rand((n, 8), dev, torch.float32, 43)
    dinv = kt.DiagonalOperator(torch.from_numpy(1.0 / sp.diagonal()).to(dev))
    dinv0 = kt.DiagonalOperator(torch.from_numpy(1.0 / lap.diagonal()).to(dev))
    blk = scipy.sparse.random(64, 64, density=0.5, random_state=9, dtype=np.float64)
    spd = scipy.sparse.csr_matrix(np.kron(np.eye(16), blk @ blk.T + 64 * np.eye(64)))
    Bb = torch.ones((spd.shape[0], 4), device=dev, dtype=torch.float64)
    grid = _grid_poisson_f32(64)  # a true grid: ILU(0)'s levels are its wavefront
    pet16 = PETOperator.from_scipy(sp, data_dtype=torch.bfloat16, with_rmatvec=False,
                                   device=dev)
    wl = dict(backend="while_loop")
    lo, hi = kt.utils.estimate_spectrum(Ac)
    Q, _ = np.linalg.qr(rng.standard_normal((96, 96)) + 1j * rng.standard_normal((96, 96)))
    hpd = Q @ np.diag(np.geomspace(1.0, 10.0, 96)) @ Q.conj().T
    bz = rng.standard_normal(96) + 1j * rng.standard_normal(96)
    Az = {dt: torch.from_numpy(hpd.astype(dt)).to(dev) for dt in (np.complex64, np.complex128)}
    bz = {dt: torch.from_numpy(bz.astype(dt)).to(dev) for dt in Az}
    return {
        "cg, grid": lambda: kt.cg(A, bg, inner=grid_inner, tol=1e-6, maxiter=400, **wl),
        "cg, const, maxiter 37": lambda: kt.cg(Ac, bc, inner=grid_inner, tol=1e-8, maxiter=37,
                                               **wl),
        "cg_stencil fused const": lambda: kt.cg_stencil(Ac, bc, tol=1e-6, maxiter=400,
                                                        fused=True),
        "cg_stencil fused var": lambda: kt.cg_stencil(A, bg, tol=1e-6, maxiter=400, fused=True),
        "cg_stencil fused jacobi": lambda: kt.cg_stencil(A, bg, tol=1e-6, maxiter=400,
                                                         fused=True, M="jacobi"),
        "cg_stencil unfused": lambda: kt.cg_stencil(A, bg, tol=1e-6, maxiter=400),
        "cg + multigrid": lambda: kt.cg(Ac, bc, M=kt.MultigridPreconditioner(Ac),
                                        inner=grid_inner, tol=1e-6, maxiter=50, **wl),
        "cg + chebyshev": lambda: kt.cg(Ac, bc, M=kt.ChebyshevPreconditioner(Ac, (lo, hi), 4),
                                        inner=grid_inner, tol=1e-6, maxiter=200, **wl),
        "bicgstab": lambda: kt.bicgstab(sp, b, Ml=dinv, tol=1e-4, maxiter=200, **wl),
        "qmr": lambda: kt.qmr(sp, b, Ml=dinv, tol=1e-4, maxiter=200, **wl),
        "bicg": lambda: kt.bicg(sp, b, tol=1e-4, maxiter=200, **wl),
        "cgs": lambda: kt.cgs(sp, b, tol=1e-4, maxiter=200, **wl),
        "minres": lambda: kt.minres(sp, b, tol=1e-4, maxiter=200, **wl),
        "lsqr": lambda: kt.lsqr(sp, b, tol=1e-4, maxiter=400, **wl),
        "cgnr": lambda: kt.cgnr(sp, b, tol=1e-4, maxiter=200, **wl),
        "richardson": lambda: kt.richardson(A, bg.reshape(-1), omega=0.05, tol=1e-30,
                                            maxiter=20, **wl),
        "jacobi": lambda: kt.jacobi(A, bg.reshape(-1), omega=0.8, tol=1e-30, maxiter=20, **wl),
        "cg + jacobi": lambda: kt.cg(lap, b, M=dinv0, tol=1e-4, maxiter=1500, **wl),
        "cg + amg": lambda: kt.cg(lap, b, M=kt.AMGPreconditioner.from_scipy(
            lap, dtype=np.float32, device=dev), tol=1e-4, maxiter=60, **wl),
        "cg + ilu": lambda: kt.cg(grid, b[:grid.shape[0]], M=kt.ILUPreconditioner.from_scipy(
            grid, device=dev), tol=1e-4, maxiter=100, **wl),
        "cg + block jacobi": lambda: kt.cg(lap, b, M=kt.BlockJacobiPreconditioner.from_scipy(
            lap, block=64, device=dev), tol=1e-3, maxiter=600, **wl),
        "cg, (N, 8) b": lambda: kt.cg(lap, B8, tol=1e-4, maxiter=600, **wl),
        "cg, bsr": lambda: kt.cg(spd, Bb, tol=1e-8, maxiter=100, **wl),
        # K10 on bfloat16 values gives float32 products: the state's types
        # change over its first two steps, which the host launches
        "cg, bf16 values": lambda: kt.cg(pet16, b.bfloat16(), tol=1e-2, maxiter=100, **wl),
        # a complex inner product's imaginary part is checked on the host
        # only on the host-stepped steps
        "cg, complex64": lambda: kt.cg(Az[np.complex64], bz[np.complex64], tol=1e-5,
                                       maxiter=200, **wl),
        "cg, complex128": lambda: kt.cg(Az[np.complex128], bz[np.complex128], tol=1e-10,
                                        maxiter=200, **wl),
        "minres, complex64": lambda: kt.minres(Az[np.complex64], bz[np.complex64], tol=1e-5,
                                               maxiter=200, **wl),
        "minres, complex128": lambda: kt.minres(Az[np.complex128], bz[np.complex128],
                                                tol=1e-10, maxiter=200, **wl),
        # the methods whose step depends on its step number: a pick on the
        # device counter, an IF node (the replacements, which fire inside
        # the replays), WHILE nodes (gmres's and gcr's sweeps)
        "cgr": lambda: kt.cgr(sp, b, tol=1e-4, maxiter=200, **wl),
        "chebyshev": lambda: kt.chebyshev(Ac, bc, (lo, hi), inner=grid_inner, tol=1e-5,
                                          maxiter=400, **wl),
        "symmlq, 60 steps": lambda: kt.symmlq(sp, b, tol=0.0, atol=0.0, maxiter=60, **wl),
        "tfqmr": lambda: kt.tfqmr(sp, b, M=dinv, tol=1e-4, maxiter=400, **wl),
        "cg, return_arnoldi": lambda: kt.cg(sp, b, tol=1e-4, maxiter=200, return_arnoldi=True,
                                            **wl),
        "cg_pipelined": lambda: kt.cg_pipelined(sp, b, M=dinv, tol=1e-5, maxiter=200,
                                                replace_every=6, **wl),
        "cg_block": lambda: kt.cg_block(lap, B8, tol=1e-4, maxiter=600, replace_every=10, **wl),
        "gcr": lambda: kt.gcr(sp, b, tol=1e-4, maxiter=100, **wl),
        "gmres mgs": lambda: kt.gmres(sp, b, tol=1e-4, maxiter=120, **wl),
        "gmres mgs2, M": lambda: kt.gmres(sp, b, M=dinv, ortho="mgs2", tol=1e-4, maxiter=120,
                                          **wl),
        "gmres cgs": lambda: kt.gmres(sp, b, ortho="cgs", tol=1e-4, maxiter=120, **wl),
        "gmres householder": lambda: kt.gmres(sp, b, ortho="householder", tol=1e-4,
                                              maxiter=120, **wl),
        "gmres restart": lambda: kt.gmres(lap, b, restart=12, tol=1e-4, maxiter=60, **wl),
    }


def _grid_poisson_f32(g, shift=0.5):
    """The shifted 5-point Laplacian on a ``g x g`` grid, no coupling across
    grid rows."""
    import scipy.sparse

    n = g * g
    side = np.ones(n - 1)
    side[g - 1::g] = 0.0
    return scipy.sparse.diags([-np.ones(n - g), -side, (4.0 + shift) * np.ones(n), -side,
                               -np.ones(n - g)], [-g, -1, 0, 1, g], format="csr",
                              dtype=np.float32)


def _launches():
    """Every kernel wrapper's launch counts, the K2 and K12 paths included."""
    from krylov_tpu_torch.ops import cuda_bsr, cuda_spmv

    return {**cs.LAUNCHES, **{f"K2 {k}": v for k, v in cs.K2_PATHS.items()},
            **cuda_spmv.LAUNCHES, **cuda_bsr.LAUNCHES,
            **{f"K12 {k}": v for k, v in cuda_bsr.K12_PATHS.items()}}


def _reset_launches():
    from krylov_tpu_torch.ops import cuda_bsr, cuda_spmv

    for mod in (cs, cuda_spmv, cuda_bsr):
        mod.reset_launches()


def _both_routes(solve, route):
    """``(host-stepped info, graph-route info, the driver's counts of the
    graph-route solve, the kernel launches of each)`` of one solve;
    ``route`` the graph route's context (a forced capture, or none)."""
    _reset_launches()
    with _driver._host_stepped():
        _, ref = solve()
    torch.cuda.synchronize()
    launches = [_launches()]
    _reset_launches()
    _driver.reset_counts()
    with route:
        _, got = solve()
    torch.cuda.synchronize()
    launches.append(_launches())
    return ref, got, dict(_driver.COUNTS), launches


_GRAPH_LABELS = (
    "cg, grid", "cg, const, maxiter 37", "cg_stencil fused const", "cg_stencil fused var",
    "cg_stencil fused jacobi", "cg_stencil unfused", "cg + multigrid", "cg + chebyshev",
    "bicgstab", "qmr", "bicg", "cgs", "minres", "lsqr", "cgnr", "richardson", "jacobi",
    "cg + jacobi", "cg + amg", "cg + ilu", "cg + block jacobi", "cg, (N, 8) b", "cg, bsr",
    "cg, bf16 values", "cg, complex64", "cg, complex128", "minres, complex64",
    "minres, complex128", "cgr", "chebyshev", "symmlq, 60 steps", "tfqmr",
    "cg, return_arnoldi", "cg_pipelined", "cg_block", "gcr", "gmres mgs", "gmres mgs2, M",
    "gmres cgs", "gmres householder", "gmres restart")


def _assert_bit_equal(got, ref, label):
    assert got.numsteps == ref.numsteps and got.success == ref.success, label
    np.testing.assert_array_equal(got.resnorms, ref.resnorms)
    assert torch.equal(got.xk, ref.xk), label
    if getattr(ref, "arnoldi", None) is not None:  # cg's return_arnoldi: V, H, P
        np.testing.assert_array_equal(got.arnoldi[1], ref.arnoldi[1])
        assert all(torch.equal(a, c) for a, c in zip(
            got.arnoldi[0] + got.arnoldi[2], ref.arnoldi[0] + ref.arnoldi[2], strict=True))


@pytest.mark.parametrize("label", _GRAPH_LABELS)
def test_graph_route_is_bit_equal_to_the_host_stepped_loop(dev, label):
    """Each solve of the slice with a capture forced after its third step
    (a graph of 4 steps, the fused CG's even count; 2 replays a read of the
    flag): one capture, and the host-stepped loop's history, step count,
    success, iterate and kernel launches (a replayed step's launches
    counted once for each time it ran) bit for bit."""
    steps = 4
    ref, got, counts, (n_host, n_graph) = _both_routes(
        _graph_cases(dev)[label], _driver._capture_at(after=3, steps=steps, replays=2))
    runs = 5 if label == "gmres restart" else 1  # a run a GMRES(12) cycle
    assert counts["graph_route"] == runs and counts["host_stepped"] == 0, counts
    assert counts["uncapturable"] == 0, (counts, _driver.LAST_GRAPH.get("uncapturable"))
    assert counts["captures"] == (runs if got.numsteps > 3 else 0), counts
    if counts["captures"]:
        # a read of the flag a run of replays, one more a failed recheck
        per_run = got.numsteps // runs
        bound = runs * (3 + -(-(per_run - 3) // (2 * steps)) + 1) + counts["rechecks"]
        assert counts["flag_reads"] <= bound, (counts, got.numsteps)
    _assert_bit_equal(got, ref, label)
    assert n_graph == n_host, label


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_graph_route_of_other_step_counts(dev, steps):
    """Graphs of 1, 3 and 8 steps: steps ending anywhere in a replay."""
    for label in ("cg, grid", "bicgstab", "minres", "cg + jacobi"):
        ref, got, counts, (n_host, n_graph) = _both_routes(
            _graph_cases(dev)[label], _driver._capture_at(after=2, steps=steps, replays=3))
        assert counts["captures"] == 1, (label, counts)
        _assert_bit_equal(got, ref, label)
        assert n_graph == n_host, label


def test_the_rule_captures_a_long_solve_and_keeps_a_short_one_on_the_host(dev):
    """Unforced: ``cg`` + Jacobi, 3000 fixed steps on a 16k-row CSR, ~10
    kernels of a few microseconds a step, is host-bound: the first
    decision (after step 24) could repay at no device time, step 25 is held
    behind a sleep to time its device work, the decision after it repays,
    step 26 is the rehearsal and the graph takes the rest.  A 2-step solve
    reaches no decision and runs the host-stepped loop's launches and
    nothing else.  Both bit-equal to the host-stepped loop, with its launch
    counts."""
    sp = _shifted_poisson_f32(128, shift=0.0)
    b = _rand(sp.shape[0], dev, torch.float32, 42)
    dinv = kt.DiagonalOperator(torch.from_numpy(1.0 / sp.diagonal()).to(dev))
    long = lambda: kt.cg(sp, b, M=dinv, tol=0.0, atol=0.0, maxiter=3000,  # noqa: E731
                         backend="while_loop")
    ref, got, counts, (n_host, n_graph) = _both_routes(long, contextlib.nullcontext())
    assert counts["captures"] == counts["held_steps"] == 1, counts
    assert _driver.LAST_GRAPH["host_steps"] == _driver.FIRST_CHECK + 2, _driver.LAST_GRAPH
    assert counts["flag_reads"] < got.numsteps / 4, counts
    _assert_bit_equal(got, ref, "cg + jacobi, 3000 steps")
    assert n_graph == n_host
    A = st.poisson_2d_const(96, 64, device=dev)
    b = torch.ones(A.grid, device=dev)
    short = lambda: kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=0.0, atol=0.0,  # noqa: E731
                          maxiter=2, backend="while_loop")
    ref, got, counts, (n_host, n_graph) = _both_routes(short, contextlib.nullcontext())
    assert counts["graph_route"] == 1 and counts["captures"] == counts["held_steps"] == 0, counts
    assert counts["host_steps"] == counts["flag_reads"] == 2
    _assert_bit_equal(got, ref, "short")
    assert n_graph == n_host and n_host["const_stencil2d_matvec"] == 2


def test_graph_route_keeps_the_callers_inputs_and_frees_its_graph(dev):
    """``cg`` with ``x0=None`` starts from ``r0 = b`` itself: the graph
    works on buffers of its own, so ``b`` is unchanged; a complex solve
    keeps its ``b`` too.  Once the solve's results are dropped the memory is
    back at its level before the solve (after a first graph solve has made
    the process's per-stream state and the kept pool): the allocated memory
    at once, the reserved memory after ``torch.cuda.empty_cache()``."""
    A = st.poisson_2d_const(96, 64, device=dev)
    b = A @ _rand(A.grid, dev, torch.float32, 44)
    b0 = b.clone()
    Az = (torch.eye(64, dtype=torch.complex64, device=dev) * 4
          + 1j * torch.diag(torch.ones(63, dtype=torch.complex64, device=dev), 1))
    Az = Az + Az.conj().T
    bz = torch.ones(64, dtype=torch.complex64, device=dev)
    bz0 = bz.clone()

    def solve():
        with _driver._capture_at(after=2, steps=4, replays=2):
            return kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=1e-6, maxiter=200,
                         backend="while_loop")

    solve()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    _driver.reset_counts()
    x, info = solve()
    assert info.success and torch.equal(b, b0) and _driver.COUNTS["captures"] == 1
    del x, info
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == base
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) == reserved
    with _driver._capture_at(after=2, steps=2, replays=2):
        _, info = kt.cg(Az, bz, tol=1e-6, maxiter=100, backend="while_loop")
    assert info.success and torch.equal(bz, bz0) and _driver.COUNTS["captures"] == 2


def test_graph_route_keeps_a_step_that_reads_the_host_on_the_host_loop(dev):
    """An ``inner`` that reads a device value on the host, and one that
    makes a tensor from host data on the device: the rehearsal step before
    the capture notes it, and the solve runs host-stepped from there,
    every time, nothing captured and nothing rerun: the host-stepped
    loop's trajectory bit for bit."""
    A = st.poisson_2d_const(64, 64, device=dev)
    b = torch.ones(A.grid, device=dev)

    def reads(u, v):
        return torch.sum(u * v) * float(u.abs().max() > 0)

    def host_value(u, v):
        return torch.sum(u * v) * torch.tensor(1.0, device=u.device)

    for inner in (reads, host_value):
        def solve():
            return kt.cg(A, b, inner=inner, tol=1e-6, maxiter=50, backend="while_loop")

        with _driver._host_stepped():
            _, ref = solve()
        for _ in range(2):
            _driver.reset_counts()
            with _driver._capture_at(after=3, steps=2, replays=2):
                _, got = solve()
            c = dict(_driver.COUNTS)
            assert c["graph_route"] == c["uncapturable"] == 1 and c["captures"] == 0, c
            assert c["host_steps"] == got.numsteps and c["graph_steps"] == 0, c
            _assert_bit_equal(got, ref, inner.__name__)
    # a capture that follows captures as ever
    _driver.reset_counts()
    with _driver._capture_at(after=3, steps=2, replays=2):
        _, info = kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=1e-6, maxiter=50,
                        backend="while_loop")
    assert _driver.COUNTS["captures"] == 1 and _driver.COUNTS["uncapturable"] == 0


def test_graph_route_raises_when_a_capture_fails(dev):
    """A step that fails only while it is captured: the solve raises a
    ``RuntimeError`` naming the solver and the operation, and nothing runs
    the solve again on the host-stepped loop."""
    A = st.poisson_2d_const(64, 64, device=dev)
    b = torch.ones(A.grid, device=dev)

    def capture_shy(u, v):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("no capture here")
        return torch.sum(u * v)

    _driver.reset_counts()
    with pytest.raises(RuntimeError, match=r"cg: .*capture_shy"):
        with _driver._capture_at(after=3, steps=2, replays=2):
            kt.cg(A, b, inner=capture_shy, tol=1e-6, maxiter=50, backend="while_loop")
    c = dict(_driver.COUNTS)
    assert c["graph_route"] == 1 and c["host_stepped"] == 0 and c["captures"] == 0, c
    assert c["host_steps"] == 3 and c["graph_steps"] == 0, c  # the rehearsal was the last
    _driver.reset_counts()
    with _driver._capture_at(after=3, steps=2, replays=2):
        _, info = kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=1e-6, maxiter=50,
                        backend="while_loop")
    assert _driver.COUNTS["captures"] == 1 and info.numsteps > 3


def test_graph_route_is_decided_before_any_capture(dev):
    """A callback, a ``ShardMonitor`` and a state that requires a gradient
    run the host-stepped loop, ``fgmres`` its own host loop; nothing is
    captured, even when forced."""
    A = st.poisson_2d_const(64, 64, device=dev)
    b = torch.ones(64 * 64, device=dev)
    Ad = torch.eye(64, device=dev) * 3.0 + torch.diag(torch.ones(63, device=dev), 1)
    Ad = Ad + Ad.T
    bd = torch.ones(64, device=dev, requires_grad=True)
    calls = []
    for solve in (
        lambda: kt.cg(A, b, tol=1e-6, maxiter=50, callback=lambda *a: calls.append(1),
                      backend="while_loop"),
        lambda: kt.cg(A, b, tol=1e-6, maxiter=50, callback=_driver.ShardMonitor(
            lambda k, r: calls.append(k)), backend="while_loop"),
        lambda: kt.cg(Ad, bd, tol=1e-6, maxiter=50, backend="while_loop"),
    ):
        _driver.reset_counts()
        with _driver._capture_at():
            solve()
        assert _driver.COUNTS["host_stepped"] == 1, _driver.COUNTS
        assert _driver.COUNTS["graph_route"] == _driver.COUNTS["captures"] == 0
    _driver.reset_counts()
    with _driver._capture_at():
        kt.fgmres(A, b, tol=1e-6, maxiter=20)
    assert _driver.COUNTS["graph_route"] == _driver.COUNTS["captures"] == 0
    assert calls

