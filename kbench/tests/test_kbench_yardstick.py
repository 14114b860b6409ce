"""The frozen byte models and peaks, and the metric arithmetic."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kbench.harness import models, stats, trace
from kbench.reference.stencil import ConstStencil


def test_const_stencil_bytes_match_the_port_model():
    from krylov_tpu_torch import profiling
    from krylov_tpu_torch.ops import ConstStencilOperator

    for grid, dtype in (((64, 32), torch.float32), ((8, 8, 8), torch.float64)):
        A = ConstStencilOperator(grid, [(0,) * len(grid)], [1.0], dtype=dtype, device="cpu")
        n = int(np.prod(grid))
        assert models.matvec_bytes("const_stencil", n, dtype.itemsize) == \
            profiling.spmv_traffic_model(A)


def test_grid_and_csr_bytes_match_the_port_model():
    import scipy.sparse

    from krylov_tpu_torch import profiling

    sp = scipy.sparse.random(100, 100, density=0.05, format="csr", random_state=3)
    A = SimpleNamespace(shape=sp.shape, nnz=sp.nnz, indptr=sp.indptr, dtype=np.float32)
    assert models.matvec_bytes("csr", 100, 4, nnz=sp.nnz) == profiling.spmv_traffic_model(A)
    G = SimpleNamespace(shape=(50, 50), coeffs2d=torch.zeros(5, 5, 10), dtype=np.float64)
    assert models.matvec_bytes("grid_stencil", 50, 8, ndiag=5) == \
        profiling.spmv_traffic_model(G)
    D = SimpleNamespace(shape=(7, 7), dtype=np.float32)
    assert models.matvec_bytes("dense", 7, 4) == profiling.spmv_traffic_model(D)


def test_peaks_match_the_port_table():
    from krylov_tpu_torch import profiling

    assert models.PEAK_GBPS == profiling.PEAK_GBPS
    assert models.peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert models.peak_gbps("NVIDIA H200 NVL") == 4800.0
    assert models.peak_gbps("cpu") is None


def test_roofline_percent():
    # 3.35 GB in one second at 3350 GB/s is 0.1 % of the bound
    assert models.roofline_percent(3.35e9, 1.0, 3350.0) == pytest.approx(0.1)
    # the least time itself reads 100 %
    assert models.roofline_percent(2e9, 2e9 / 3350e9, 3350.0) == pytest.approx(100.0)


@pytest.mark.parametrize("values", [[3.0], [1.0, 2.0], list(range(1, 102)),
                                    [5.0, 1.0, 4.0, 2.0, 3.0, 9.0, 7.5]])
def test_percentile_interpolates_like_the_inclusive_quantiles(values):
    if len(values) > 1:
        assert stats.percentile(values, 90) == pytest.approx(
            statistics.quantiles(values, n=10, method="inclusive")[8])
        assert stats.percentile(values, 90) == pytest.approx(np.percentile(values, 90))
    else:
        assert stats.percentile(values, 90) == values[0]


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 9.0, 10.5, 10.2, 9.8]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv) == 8
    assert stats.union_length(iv, 1, 10) == 2 + 1 + 2
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (6, 8)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _ev(name, kind, start, end, thread=1, device_time=0.0):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if kind == "gpu" else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=thread,
        device_time_total=device_time)


def test_trace_reduction_on_synthetic_events():
    events = [
        _ev(trace.WINDOW, "cpu", 0, 100),
        _ev("kbench.solve", "cpu", 0, 100),
        _ev("kbench.precond", "cpu", 10, 30, device_time=15.0),
        _ev("aten::mul", "cpu", 12, 14),
        _ev("aten::item", "cpu", 60, 80),
        _ev("k2", "gpu", 5, 20),
        _ev("k2", "gpu", 15, 25),
        _ev("axpy", "gpu", 40, 50),
        _ev("kbench.precond", "gpu", 5, 25),  # a device-side annotation: not work
        _ev("late", "gpu", 95, 120),  # clipped to the window for busy time
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert t.kernels["k2"] == [pytest.approx(25e-6), 2]
    assert "kbench.precond" not in t.kernels
    assert t.spans["kbench.precond"] == pytest.approx(15e-6)
    # gaps: 0-5 (solve), 25-40 (solve: Python), 50-95 (mid 72.5 in aten::item)
    assert t.gaps["aten::item"] == pytest.approx(45e-6)
    assert t.gaps["Python between operations"] == pytest.approx(20e-6)
    assert trace.top(t.gaps, 1) == [["aten::item", pytest.approx(45e-6)]]


def test_reference_stencil_against_a_dense_laplacian():
    A = ConstStencil((5, 4), [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)],
                     [4.0, -1.0, -1.0, -1.0, -1.0], torch.float64, "cpu")
    T = lambda m: 2 * np.eye(m) - np.eye(m, k=1) - np.eye(m, k=-1)  # noqa: E731
    dense = np.kron(T(5), np.eye(4)) + np.kron(np.eye(5), T(4))
    assert np.array_equal(A.dense().numpy(), dense)
    x = torch.randn(5, 4, 3, dtype=torch.float64)
    y = (torch.from_numpy(dense) @ x.reshape(20, 3)).reshape(5, 4, 3)
    assert torch.allclose(A @ x, y, rtol=0, atol=1e-12)
