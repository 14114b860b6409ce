"""krylov_tpu_torch grid-stencil operators and the K1 stencil kernel's plain
version, held to the JAX package on the CPU.

Inputs are made from a seed with numpy and go through both packages.  The
CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py); here the
wrappers take their plain versions because the tensors lie on the CPU.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from krylov_tpu.ops import pallas_stencil as ps
from krylov_tpu.ops import stencil as js
import krylov_tpu_torch
from krylov_tpu_torch import DiagonalOperator, MatrixOperator, convert
from krylov_tpu_torch.ops import cuda_stencil as cs
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)
krylov_tpu_torch.set_default_device("cpu")  # these tests run on the CPU

# (name, JAX constructor, port constructor): f64, small grids
OPS = {
    "poisson_2d": (lambda: js.poisson_2d(8, 16), lambda: ts.poisson_2d(8, 16)),
    "poisson_3d_h4": (lambda: js.poisson_3d(4, 5, 8), lambda: ts.poisson_3d(4, 5, 8)),
    "diffusion_2d": (
        lambda: js.diffusion_2d(_lognormal((8, 12))),
        lambda: ts.diffusion_2d(_lognormal((8, 12))),
    ),
}


def _lognormal(shape, seed=11):
    return np.exp(np.random.default_rng(seed).standard_normal(shape))


def _pair(name):
    make_j, make_t = OPS[name]
    return make_j(), make_t()


def _vector(kind, grid, rng):
    M, ny = grid
    shape = {"flat": (M * ny,), "grid": (M, ny), "nk": (M * ny, 3),
             "grid_k": (M, ny, 3)}[kind]
    return rng.standard_normal(shape)


@pytest.mark.parametrize("kind", ["flat", "grid", "nk", "grid_k"])
@pytest.mark.parametrize("name", list(OPS))
def test_matvec_matches_reference(name, kind):
    """All four vector shapes of ``__matmul__``, f64 at atol 1e-13."""
    Aj, At = _pair(name)
    x = _vector(kind, At.grid, np.random.default_rng(0))
    want = np.asarray(Aj @ jnp.asarray(x))
    got = At @ torch.from_numpy(x)
    assert tuple(got.shape) == x.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("extra", [0, 2])
@pytest.mark.parametrize("name", ["poisson_2d", "poisson_3d_h4"])
def test_caller_halos_match_reference(name, extra):
    """Caller halos of ``h + extra`` rows: the rows next to the grid count."""
    Aj, At = _pair(name)
    h = At.halo
    rng = np.random.default_rng(1)
    M, ny = At.grid
    x = rng.standard_normal((M, ny))
    top, bot = rng.standard_normal((2, h + extra, ny))
    want = Aj._matvec_2d(
        Aj.coeffs2d, jnp.asarray(x), jnp.asarray(top[-h:]), jnp.asarray(bot[:h])
    )
    got = At._apply_grid(
        torch.from_numpy(x), torch.from_numpy(top), torch.from_numpy(bot)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)


def test_banded_matches_reference():
    """Non-hermitian BandedOperator: matvec and rmatvec, flat and (N, k)."""
    rng = np.random.default_rng(2)
    n, offsets = 30, (-7, -1, 0, 2, 5)
    coeffs = rng.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):  # zero the out-of-range columns
        if off > 0:
            coeffs[d, n - off :] = 0
        elif off < 0:
            coeffs[d, :-off] = 0
    Aj = js.BandedOperator(jnp.asarray(coeffs), offsets)
    At = ts.BandedOperator(torch.from_numpy(coeffs), offsets)
    for x in (rng.standard_normal(n), rng.standard_normal((n, 2))):
        xt = torch.from_numpy(x)
        np.testing.assert_allclose((At @ xt).numpy(), np.asarray(Aj @ x), atol=1e-13)
        np.testing.assert_allclose(
            At.rmatvec(xt).numpy(), np.asarray(Aj.rmatvec(x)), atol=1e-13
        )
    assert At.nnz == Aj.nnz
    np.testing.assert_array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))


@pytest.mark.parametrize("name", list(OPS))
def test_grid_rmatvec_and_diagonal(name):
    Aj, At = _pair(name)
    x = np.random.default_rng(3).standard_normal(At.shape[0])
    np.testing.assert_allclose(
        At.rmatvec(torch.from_numpy(x)).numpy(), np.asarray(Aj.rmatvec(x)), atol=1e-13
    )
    np.testing.assert_array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))
    assert At.offsets == Aj.offsets and At.row_offsets == Aj.row_offsets
    assert At.col_offsets == Aj.col_offsets and At.shape == Aj.shape


def test_poisson_1d_matches_reference():
    Aj, At = js.poisson_1d(9), ts.poisson_1d(9)
    x = np.random.default_rng(4).standard_normal(9)
    np.testing.assert_allclose(
        (At @ torch.from_numpy(x)).numpy(), np.asarray(Aj @ x), atol=1e-14
    )


def _pallas_k1(A, x2, tm):
    """The reference K1 body (``ps._kernel``) in Pallas interpret mode."""
    ndiag, M, ny = A.coeffs2d.shape
    nb = M // tm
    h = max(1, max(abs(r) for r in A.row_offsets))
    xr = x2.reshape(nb, tm, ny)
    zero = jnp.zeros((1, h, ny), jnp.float32)
    tops = jnp.concatenate([zero, xr[:-1, tm - h :]], axis=0)
    bots = jnp.concatenate([xr[1:, :h], zero], axis=0)
    return pl.pallas_call(
        functools.partial(ps._kernel, row_offsets=A.row_offsets,
                          col_offsets=A.col_offsets, h=h, tm=tm),
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((ndiag, tm, ny), lambda i: (0, i, 0)),
            pl.BlockSpec((tm, ny), lambda i: (i, 0)),
            pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, h, ny), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((tm, ny), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, ny), jnp.float32),
        interpret=True,
    )(jnp.asarray(A.coeffs2d, jnp.float32), x2, tops, bots)


@pytest.mark.parametrize(
    "make_j,make_t",
    [
        (lambda: js.poisson_2d(16, 8, dtype=np.float32),
         lambda: ts.poisson_2d(16, 8, dtype=np.float32)),
        (lambda: js.diffusion_2d(_lognormal((16, 8)), dtype=np.float32),
         lambda: ts.diffusion_2d(_lognormal((16, 8)), dtype=np.float32)),
        (lambda: js.poisson_3d(4, 4, 8, dtype=np.float32),
         lambda: ts.poisson_3d(4, 4, 8, dtype=np.float32)),
    ],
    ids=["poisson_2d", "diffusion_2d", "poisson_3d_h4"],
)
def test_k1_plain_matches_pallas_interpret(make_j, make_t):
    """K1's plain version against the Pallas kernel body, f32 at atol 1e-5."""
    Aj, At = make_j(), make_t()
    x = np.random.default_rng(5).standard_normal(At.grid).astype(np.float32)
    with jax.disable_jit():
        want = _pallas_k1(Aj, jnp.asarray(x), tm=8)
    got = cs.stencil2d_matvec(At.coeffs2d, torch.from_numpy(x), At.row_offsets,
                              At.col_offsets)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_k1_plain_bf16_accumulates_in_f32():
    """bf16 inputs: accumulate in f32, round once to the bf16 output."""
    At = ts.diffusion_2d(_lognormal((8, 12)), dtype=np.float32)
    c = At.coeffs2d.to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(At.grid)).to(
        torch.bfloat16
    )
    got = cs.stencil2d_matvec(c, x, At.row_offsets, At.col_offsets)
    want = cs.stencil2d_matvec_plain(c.float(), x.float(), At.row_offsets,
                                     At.col_offsets).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    mixed = cs.stencil2d_matvec(c, x.float(), At.row_offsets, At.col_offsets)
    assert mixed.dtype == torch.float32


def test_wrappers_on_cpu_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch counts,
    and ``out=`` is honoured."""
    cs.reset_launches()
    At = ts.poisson_2d(8, 16, dtype=np.float32)
    x = torch.ones(At.grid)
    out = torch.empty(At.grid)
    y = cs.stencil2d_matvec(At.coeffs2d, x, At.row_offsets, At.col_offsets, out=out)
    assert y is out
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device raises: no quiet
    fallback to the plain version; nor does a CPU/other-device mix."""
    At = ts.poisson_2d(4, 8, dtype=np.float32)
    x = torch.empty(At.grid, device="meta")
    with pytest.raises(NotImplementedError):
        cs.stencil2d_matvec(At.coeffs2d.to("meta"), x, At.row_offsets,
                            At.col_offsets)
    with pytest.raises(ValueError):
        cs.stencil2d_matvec(At.coeffs2d, x, At.row_offsets, At.col_offsets)


def test_convert_round_trip():
    """``from_reference`` and ``grid_stencil_from_numpy`` carry JAX
    operators across (read-only arrays copied), and the twins agree."""
    rng = np.random.default_rng(7)
    Aj = js.diffusion_2d(_lognormal((6, 10)))
    x = rng.standard_normal(60)
    for At in (
        convert.from_reference(Aj),
        convert.grid_stencil_from_numpy(
            np.asarray(Aj.coeffs2d), Aj.offsets, Aj.ny, hermitian=True
        ),
    ):
        assert isinstance(At, ts.GridStencilOperator) and At.hermitian
        At.coeffs2d.add_(0.0)  # writable: the arrays were copied
        np.testing.assert_allclose(
            (At @ torch.from_numpy(x)).numpy(), np.asarray(Aj @ x), atol=1e-13
        )
    Bj = js.poisson_1d(7)
    Bt = convert.from_reference(Bj)
    assert type(Bt) is ts.BandedOperator and Bt.offsets == Bj.offsets

    from krylov_tpu import DiagonalOperator as JDiag
    from krylov_tpu._operators import MatrixOperator as JMat

    dense = rng.standard_normal((5, 5))
    Mt = convert.from_reference(JMat(jnp.asarray(dense)))
    assert isinstance(Mt, MatrixOperator)
    np.testing.assert_array_equal(Mt.a.numpy(), dense)
    Dt = convert.from_reference(JDiag(jnp.arange(1.0, 6.0)))
    assert isinstance(Dt, DiagonalOperator)
    np.testing.assert_array_equal(Dt.d.numpy(), np.arange(1.0, 6.0))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, krylov_tpu_torch, krylov_tpu_torch.convert, "
        "krylov_tpu_torch.ops.cuda_stencil, krylov_tpu_torch._build, "
        "krylov_tpu_torch.multigrid, krylov_tpu_torch.utils, "
        "krylov_tpu_torch.solvers.stationary, krylov_tpu_torch.ops.triangular, "
        "krylov_tpu_torch.amg, krylov_tpu_torch.ilu, krylov_tpu_torch.blockjacobi, "
        "krylov_tpu_torch.ops._native, krylov_tpu_torch.diffable, "
        "krylov_tpu_torch.profiling, krylov_tpu_torch.parallel, "
        "krylov_tpu_torch.parallel._spawn, krylov_tpu_torch.parallel.amg, "
        "krylov_tpu_torch.parallel.schwarz; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'krylov_tpu', 'triton', 'scipy')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # building and applying the sparse preconditioners (host set-up in scipy
    # and the port's own native helpers) loads neither either
    code = (
        "import sys, numpy as np, scipy.sparse, torch, krylov_tpu_torch as kt; "
        "kt.set_default_device('cpu'); "
        "A = scipy.sparse.diags([-1., -1., 4., -1., -1.], [-30, -1, 0, 1, 30], "
        "shape=(900, 900), format='csr'); r = torch.ones(900, dtype=torch.float64); "
        "[M @ r for M in (kt.AMGPreconditioner.from_scipy(A, coarse_size=50), "
        "kt.ILUPreconditioner.from_scipy(A), kt.BlockJacobiPreconditioner.from_scipy(A))]; "
        "P = kt.parallel; "
        "[p.as_global() @ r for p in (P.partition_amg(A, 2, coarse_size=50), "
        "P.partition_ilu0(A, 2), P.partition_block_jacobi(A, 2, block=30))]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'krylov_tpu', 'triton')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_operator_protocols_match_the_references():
    """``LinearOperator`` and ``RLinearOperator``, the reference's typing
    protocols (``krylov_tpu/_operators.py``), with the same members."""
    from krylov_tpu import _operators as ref
    from krylov_tpu_torch import _operators as ops

    for name in ("LinearOperator", "RLinearOperator"):
        got, want = getattr(ops, name), getattr(ref, name)
        assert got._is_protocol and got.__protocol_attrs__ == want.__protocol_attrs__
