"""The port's native set-up helpers (``krylov_tpu_torch/ops/_native.py``)
held to their numpy ground truth and to the reference's helpers on the CPU.

The cases of ``tests/test_native_ab.py`` run through the port: the ILU(0)
numerics of ``csrc/host/ilu0.cpp`` against the numpy row pass (rtol 1e-14)
and bit for bit against the reference's native result; the AMG matching of
``amg_agg.cpp`` label for label against numpy, in float32 and float64; the
Galerkin product of ``amg_rap.cpp`` against scipy's triple product (the same
pattern, values at 1e-13 in float64 and 1e-5 in float32) and bit for bit
against the reference's; the dependency levels of ``tri_levels`` equal to
the numpy frontier pass.  ``KRYLOV_TORCH_NO_NATIVE`` turns the natives off,
and ``NATIVE_PATHS`` counts each route.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu.ops._native as jnative
import krylov_tpu_torch as kt
from krylov_tpu_torch import amg as tamg
from krylov_tpu_torch import ilu as tilu
from krylov_tpu_torch.ops import _native
from krylov_tpu_torch.ops import triangular as ttri

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def numpy_only(monkeypatch):
    """The numpy set-up paths: natives off for the test's duration."""
    monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")


@pytest.fixture(autouse=True)
def _native_built():
    """Every test here compares the two routes: without a g++ there is one."""
    for stem in ("amg_agg", "amg_rap", "ilu0"):
        if _native._built(stem) is None:
            pytest.skip(f"the native {stem} does not build here")


def _test_matrices():
    rng = np.random.default_rng(7)
    n_side = 40
    n = n_side * n_side
    lap = scipy.sparse.diags([-1.0, -1.0, 4.0, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
                             shape=(n, n), format="csr")
    R = scipy.sparse.random(500, 500, density=0.02, format="csr", random_state=rng)
    unsym = (R + 8.0 * scipy.sparse.eye(500, format="csr")).tocsr()
    unsym.sort_indices()
    return {"poisson": lap, "unsym": unsym}


MATRICES = ["poisson", "unsym"]


@pytest.mark.parametrize("name", ["amg_agg.cpp", "amg_rap.cpp", "ilu0.cpp"])
def test_host_sources_are_the_references_sources(name):
    """The port builds its own copy, byte for byte the reference's."""
    mine = REPO / "krylov_tpu_torch" / "csrc" / "host" / name
    assert filecmp.cmp(mine, REPO / "krylov_tpu" / "csrc" / name, shallow=False)


@pytest.mark.parametrize("name", MATRICES)
def test_ilu0_native_matches_numpy_and_the_reference(name):
    A = _test_matrices()[name].astype(np.float64)
    A.sort_indices()
    native = _native.ilu0_factor_native(A)
    np.testing.assert_allclose(native, tilu._ilu0_numeric_numpy(A), rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(native, jnative.ilu0_factor_native(A))


def test_ilu0_complex_takes_numpy_route():
    """The kernel is real float64: a complex matrix returns None and still
    factors (the ILU(0) defining property on A's pattern)."""
    rng = np.random.default_rng(3)
    n = 64
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = scipy.sparse.csr_matrix(np.eye(n) * (8.0 + 0j) + 0.25 * C)
    H.sort_indices()
    assert _native.ilu0_factor_native(H) is None
    L, U = tilu._ilu0_factor(H)
    mask = H.copy()
    mask.data = np.ones_like(mask.data)
    assert abs((L @ U).tocsr().multiply(mask) - H).max() <= 1e-10


def test_ilu0_factor_same_through_public_path(monkeypatch):
    A = _test_matrices()["poisson"].astype(np.float64)
    Ln, Un = tilu._ilu0_factor(A)
    monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")
    Lp, Up = tilu._ilu0_factor(A)
    assert abs(Ln - Lp).max() <= 1e-14 and abs(Un - Up).max() <= 1e-14


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", MATRICES)
def test_amg_aggregation_native_matches_numpy(name, dtype, monkeypatch):
    """amg_agg.cpp gives exactly the numpy labels (the same strength values,
    jitter and stable sort, the key's arithmetic unfused), and both equal
    the reference's."""
    A = _test_matrices()[name].tocsr().astype(dtype)
    A.sort_indices()
    labels, n_agg = _native.amg_pairwise_labels_native(A, 0.08)
    monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")
    ref_labels, ref_n = tamg._pairwise_labels(A, 0.08)
    assert n_agg == ref_n
    np.testing.assert_array_equal(labels, ref_labels)
    j_labels, j_n = jnative.amg_pairwise_labels_native(A, 0.08)
    assert j_n == n_agg
    np.testing.assert_array_equal(j_labels, labels)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_full_setup_native_off_equivalent(dtype, monkeypatch):
    A = _test_matrices()["poisson"].astype(dtype)
    on = kt.AMGPreconditioner.from_scipy(A)
    monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")
    off = kt.AMGPreconditioner.from_scipy(A)
    assert on.n_levels >= 2 and on.level_sizes == off.level_sizes
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0]).astype(dtype))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    torch.testing.assert_close(on @ r, off @ r, rtol=tol, atol=tol * float((off @ r).abs().max()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", MATRICES)
def test_amg_rap_native_matches_scipy_and_the_reference(name, dtype):
    """amg_rap.cpp against the scipy triple product (the need_P route of
    ``_smoothed_prolongator``): the same pattern, values at the dtype's
    precision; the tentative relabel-and-sum exactly; and bit for bit the
    reference's native product."""
    Al = _test_matrices()[name].astype(dtype).tocsr()
    Al.sort_indices()
    labels, n_agg = tamg._aggregate(Al, 0.08)
    lmax = tamg._lmax_estimate(Al, "power")
    d = Al.diagonal()
    scale = (4.0 / (3.0 * lmax)) / np.where(d != 0, d, 1.0)
    got = _native.amg_rap_native(Al, labels, n_agg, scale)
    P = scipy.sparse.csr_matrix((np.ones(Al.shape[0], dtype), (np.arange(Al.shape[0]), labels)),
                                shape=(Al.shape[0], n_agg))
    AP = (Al @ P).tocsr()
    AP.data *= np.repeat(scale.astype(dtype), np.diff(AP.indptr))
    P2 = (P - AP).tocsr()
    ref = (P2.T @ Al @ P2).tocsr()
    ref.sort_indices()
    rtol = 1e-5 if dtype == np.float32 else 1e-13
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=rtol, atol=rtol * abs(ref.data).max())
    assert got.dtype == dtype
    j = jnative.amg_rap_native(Al, labels, n_agg, scale)
    np.testing.assert_array_equal(got.data, j.data)
    got0 = _native.amg_rap_native(Al, labels, n_agg, None)
    C = Al.tocoo()
    ref0 = scipy.sparse.csr_matrix((C.data, (labels[C.row], labels[C.col])), shape=(n_agg, n_agg))
    assert abs(got0 - ref0).max() == 0.0


def test_amg_rap_complex_takes_scipy_route():
    rng = np.random.default_rng(5)
    n = 128
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = scipy.sparse.csr_matrix(np.eye(n) * 12.0 + 0.5 * (C + C.conj().T))
    H.sort_indices()
    assert _native.amg_rap_native(H, np.zeros(n, np.int64), 1, None) is None
    assert kt.AMGPreconditioner.from_scipy(H, coarse_size=16).n_levels >= 1


def _triangles():
    """Lower and upper factors of growing depth: the ILU(0) factors of the
    test matrices, a 2-D grid's triangle (wavefront depth), and a random
    unstructured lower triangle (logarithmic depth)."""
    out = []
    for name, A in _test_matrices().items():
        L, U = tilu._ilu0_factor(A.astype(np.float64))
        out += [(f"{name} L", L, True), (f"{name} U", U, False)]
    g = 30
    T = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    grid = (scipy.sparse.kron(scipy.sparse.eye(g), T) + scipy.sparse.kron(T, scipy.sparse.eye(g)))
    out.append(("grid lower", scipy.sparse.tril(grid).tocsr(), True))
    rng = np.random.default_rng(2)
    n = 3000
    rows = np.repeat(np.arange(1, n), 3)
    cols = (rng.random(rows.size) * rows).astype(np.int64)
    R = scipy.sparse.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    out.append(("unstructured", (R + scipy.sparse.eye(n)).tocsr(), True))
    out.append(("unstructured upper", (R.T + scipy.sparse.eye(n)).tocsr(), False))
    return out


@pytest.mark.parametrize("case", range(7))
def test_tri_levels_native_equals_the_frontier_pass(case):
    label, T, lower = _triangles()[case]
    T = T.tocsr()
    T.sort_indices()
    native = _native.tri_levels_native(T, lower)
    level, nlev = ttri._dependency_levels(T.indptr, T.indices, T.shape[0], lower, 1 << 30)
    np.testing.assert_array_equal(native, level, err_msg=label)
    assert int(native.max()) + 1 == nlev
    np.testing.assert_array_equal(native, jnative.tri_levels_native(T, lower))


def test_level_arrays_same_on_both_routes(monkeypatch):
    for label, T, lower in _triangles():
        n, native = ttri.level_arrays(T, lower=lower, max_levels=4096)
        monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")
        _, numpy_levels = ttri.level_arrays(T, lower=lower, max_levels=4096)
        monkeypatch.delenv("KRYLOV_TORCH_NO_NATIVE")
        assert len(native) == len(numpy_levels), label
        for a, b in zip(native, numpy_levels):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=label)


def test_level_guard_on_both_routes(monkeypatch):
    _, T, lower = _triangles()[4]  # the grid's triangle: 59 levels
    for off in (False, True):
        if off:
            monkeypatch.setenv("KRYLOV_TORCH_NO_NATIVE", "1")
        with pytest.raises(NotImplementedError, match="dependency levels"):
            ttri.level_arrays(T, lower=lower, max_levels=58)
        assert len(ttri.level_arrays(T, lower=lower, max_levels=59)[1]) == 59


def test_native_paths_count_each_route(numpy_only, monkeypatch):
    A = _test_matrices()["poisson"].astype(np.float64)
    _native.reset_native_paths()
    kt.AMGPreconditioner.from_scipy(A)
    kt.ILUPreconditioner.from_scipy(A)
    off = {k: dict(v) for k, v in _native.NATIVE_PATHS.items()}
    assert all(v["native"] == 0 and v["numpy"] > 0 for v in off.values()), off
    monkeypatch.delenv("KRYLOV_TORCH_NO_NATIVE")
    _native.reset_native_paths()
    kt.AMGPreconditioner.from_scipy(A)
    kt.ILUPreconditioner.from_scipy(A)
    on = _native.NATIVE_PATHS
    assert all(v["numpy"] == 0 and v["native"] > 0 for v in on.values()), on
    # two matchings and one relabel-sum a coarsening step, two level passes
    # (L and U) an ILU factor
    assert on["tri_levels"]["native"] == 2 and on["ilu0_factor"]["native"] == 1


def test_build_is_named_by_its_source_and_flags():
    path = _native.build_host("amg_agg")
    assert path.parent == _native.BUILD_DIR and path.exists()
    assert path.name.startswith("libamg_agg_") and _native.build_host("amg_agg") == path
    assert path != _native.build_host("amg_rap")
