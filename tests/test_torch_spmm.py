"""K11, the CSR SpMM kernel (``cuda_spmv.csr_matmat``), on the CPU.

``csrc/spmv.cu`` fixes K11's order of sums by the matrix and ``k`` alone;
``_matmat_by_runs`` below is that order on the host in float32, held to
scipy's float64 product and to the reference's ``pet_matmat`` (interpret
mode).  Beside it: how the kernel deals the columns of X to its lanes, and
``PETOperator`` handing its one row partition to K11 through
``tree_flatten``/``tree_unflatten``.  Inputs are made from numpy seeds.
"""

import functools
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu_torch as kt
from krylov_tpu.ops import pallas_spmv as j_spmv
from krylov_tpu_torch.ops import cuda_spmv
from tests.test_torch_sparse import RUN_CASES as CASES  # K10's and K11's row partition

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

# csrc/spmv.cu's constants that fix K11's order of sums
_SRC = (Path(cuda_spmv.__file__).parents[1] / "csrc" / "spmv.cu").read_text()
THREADS, SLAB, LANE_ENTRIES = (
    int(re.search(rf"#define KRYLOV_{name} (\d+)", _SRC).group(1))
    for name in ("SPMV_THREADS", "SPMM_SLAB", "SPMM_LANE_ENTRIES"))
KS = (1, 3, 8, 16, 17)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(name):
    sp = CASES[name].astype(np.float32)
    sp.sort_indices()
    return sp


def _slot_lanes(kslab):
    """The float4 lanes a slab needs, ``C``, and the lanes of a row slot,
    ``Cp``: ``C`` rounded up to a power of two."""
    C = -(-kslab // 4)
    return C, 1 << (C - 1).bit_length()


def _fma(acc, v, x):
    """float32 fused multiply-add: the product is exact in float64, the sum
    rounded once there and then to float32 (a double rounding the kernel
    does not make: it can move a sum by one float32 ulp)."""
    return (acc.astype(np.float64) + v.astype(np.float64) * x.astype(np.float64)) \
        .astype(np.float32)


def _tree(parts, axis):
    """Shuffle-down tree over a power-of-two axis: part t += part t + h."""
    while parts.shape[axis] > 1:
        lo, hi = np.split(parts, 2, axis=axis)
        parts = (lo + hi).astype(np.float32)
    return np.squeeze(parts, axis)


def _matmat_by_runs(sp, X, capacity=cuda_spmv.RUN_CAPACITY, slab=SLAB,
                    lane_entries=LANE_ENTRIES):
    """K11 as csrc/spmv.cu computes it, on the host in float32: for each
    slab of ``slab`` columns and each run of ``csr_runs``, ``G`` row slots a
    row (from the run's mean row length and the slab's lanes), slot ``t``
    taking the row's entries ``t, t + G, ...`` by FMA in order, the slots
    meeting in a shuffle tree; a run of one row summed by 256 / Cp slots,
    a tree in each warp and a tree over the 8 warps."""
    indptr = sp.indptr.astype(np.int64)
    nnz = int(indptr[-1])
    # one zero entry past the end stands for every padded slot
    indices = np.r_[sp.indices[:nnz], 0].astype(np.int64)
    data = np.r_[sp.data[:nnz], 0].astype(np.float32)
    X = X.astype(np.float32)
    n, k = sp.shape[0], X.shape[1]
    Y = np.full((n, k), np.nan, np.float32)
    runs = cuda_spmv.csr_runs(indptr, capacity)
    for c0 in range(0, k, slab):
        Xs = X[:, c0:c0 + slab]
        _, Cp = _slot_lanes(Xs.shape[1])
        for r0, r1 in zip(runs[:-1], runs[1:]):
            e0, e1 = indptr[r0], indptr[r1]
            if r1 - r0 == 1:
                S = THREADS // Cp
                steps = -(-(e1 - e0) // S)
                e = e0 + np.arange(steps * S).reshape(steps, S)
                e = np.where(e < e1, e, nnz)
                acc = np.zeros((S, Xs.shape[1]), np.float32)
                for i in range(steps):
                    acc = _fma(acc, data[e[i]][:, None], Xs[indices[e[i]]])
                warps = _tree(acc.reshape(8, S // 8, -1), 1)
                Y[r0, c0:c0 + slab] = _tree(warps, 0)
                continue
            mean = (e1 - e0) // (r1 - r0)
            G = 1
            while G * Cp < 32 and 2 * G * lane_entries <= mean:
                G *= 2
            lens = indptr[r0 + 1:r1 + 1] - indptr[r0:r1]
            steps = -(-int(lens.max()) // G)
            pos = (np.arange(steps)[:, None] * G + np.arange(G))[None]  # (1, steps, G)
            e = np.where(pos < lens[:, None, None], indptr[r0:r1, None, None] + pos, nnz)
            acc = np.zeros((r1 - r0, G, Xs.shape[1]), np.float32)
            for i in range(steps):
                acc = _fma(acc, data[e[:, i]][..., None], Xs[indices[e[:, i]]])
            Y[r0:r1, c0:c0 + slab] = _tree(acc, 1)
    return Y


@functools.cache
def _reference_product(name):
    """The reference's ``pet_matmat`` (interpret mode) of case ``name`` with
    the columns of every k of ``KS`` side by side, and that X."""
    sp = _case(name)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((sp.shape[1], sum(KS))).astype(np.float32)
    if not sp.nnz:
        return X, np.zeros((sp.shape[0], X.shape[1]), np.float32)
    ref = j_spmv.PETOperator.from_scipy(sp, interpret=True, with_rmatvec=False)
    return X, np.asarray(ref @ jnp.asarray(X))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CASES))
def test_matmat_by_runs_matches_scipy_and_reference_kernel(name, k):
    """K11's order of sums against scipy's float64 product and the
    reference's PET kernel, each at 1e-5 of the output's scale: float32
    sums of at most 5000 products in differing orders.  Every row and
    column is written once."""
    sp = _case(name)
    X_all, ref_all = _reference_product(name)
    c = sum(KS[:KS.index(k)])
    X, ref = X_all[:, c:c + k], ref_all[:, c:c + k]
    got = _matmat_by_runs(sp, X)
    assert not np.isnan(got).any()
    want = sp.astype(np.float64) @ X.astype(np.float64)
    scale = max(np.abs(want).max(initial=0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    # the wrapper's CPU path (the plain version), the runs passed, agrees too
    plain = cuda_spmv.csr_matmat(_t(sp.indptr.astype(np.int32)), _t(sp.indices.astype(np.int32)),
                                 _t(sp.data), _t(X), _t(cuda_spmv.csr_runs(sp.indptr)))
    np.testing.assert_allclose(plain.numpy(), got, rtol=0, atol=1e-5 * scale)


def test_matmat_by_runs_covers_slabs_and_long_rows():
    """The model past one slab (k = 70: slabs of 32, 32 and 6 columns) and
    with a run of one row at every slab width, against scipy."""
    sp = _case("dense row")
    X = np.random.default_rng(12).standard_normal((sp.shape[1], 70)).astype(np.float32)
    got = _matmat_by_runs(sp, X)
    want = sp.astype(np.float64) @ X.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _lane_columns(k, slab=SLAB):
    """For each slab, the lanes of a row slot and the columns of X each
    holds, as csrc/spmv.cu deals them: lane c takes the slab's columns 4c ..
    4c + 3 (one 16-byte load on the float4 path, four 4-byte loads on the
    other)."""
    out = []
    for c0 in range(0, k, slab):
        kslab = min(slab, k - c0)
        _, Cp = _slot_lanes(kslab)
        out.append((Cp, [[c0 + j for j in range(4 * c, min(4 * c + 4, kslab))]
                         for c in range(Cp)]))
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 64])
def test_lanes_take_every_column_once(k):
    """Every column of X in exactly one lane of one slab, at most 4
    neighbouring columns a lane; a row slot's lanes are the fewest, as a
    power of two (the shuffle width), that hold the slab, at most 32; one
    slab, so one pass over the matrix, for every 32 columns."""
    slabs = _lane_columns(k)
    seen = []
    for Cp, lanes in slabs:
        kslab = sum(len(cols) for cols in lanes)
        assert Cp <= 32 and Cp & (Cp - 1) == 0 and len(lanes) == Cp
        assert Cp == 1 or 4 * (Cp // 2) < kslab <= 4 * Cp
        for cols in lanes:
            assert not cols or len(cols) <= 4 and cols == list(range(cols[0], cols[-1] + 1))
        seen += [c for cols in lanes for c in cols]
    assert sorted(seen) == list(range(k))
    assert len(slabs) == -(-k // SLAB)


def test_pet_operator_hands_its_partition_to_k11_through_flattening():
    """A ``PETOperator`` with an ``(N, k)`` right-hand side, rebuilt from its
    leaves, passes the runs it cut once to K11 for the forward and the
    adjoint product and never cuts them again (no host read inside a
    solve); the products match scipy."""
    sp = _case("bench irregular")
    op = cuda_spmv.PETOperator.from_scipy(sp, with_rmatvec=True)
    leaves, aux = op.tree_flatten()
    op2 = cuda_spmv.PETOperator.tree_unflatten(aux, leaves)
    B = np.random.default_rng(13).standard_normal((sp.shape[0], 8)).astype(np.float32)
    seen = []
    plain = cuda_spmv.csr_matmat

    def spy(indptr, indices, data, X, runs=None):
        seen.append(runs)
        return plain(indptr, indices, data, X, runs)

    def refuse(indptr):
        raise AssertionError("the operator's product cut the runs again")

    with mock.patch.object(cuda_spmv, "csr_matmat", spy), \
            mock.patch.object(cuda_spmv, "cached_runs", refuse):
        Y, Yt = op2 @ _t(B), op2.rmatvec(_t(B))
    assert seen[0] is op._csr.runs and seen[1] is op._csr_t.runs
    for got, mat in ((Y, sp), (Yt, sp.T)):
        want = mat.astype(np.float64) @ B.astype(np.float64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
