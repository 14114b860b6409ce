"""``krylov_tpu_torch.profiling`` against ``krylov_tpu.profiling`` on the CPU
(``tests/test_aux_subsystems.py``'s profiling cases): the byte models equal
the reference's for every operator type but ``PETOperator``, whose CSR
kernel is the port's own and is held to its own formula; the timed solve,
the roofline report, the bandwidth table and the trace file."""

import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import profiling as jprofiling
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import convert, profiling
from krylov_tpu_torch.ops import stencil as st
from krylov_tpu_torch.ops.cuda_spmv import PETOperator

kt.set_default_device("cpu")


def test_traffic_model_by_operator_type():
    Ac = jst.poisson_2d_const(8, 16, dtype=np.float32)
    Av = jst.poisson_2d(8, 16, dtype=np.float32)
    n = 128
    for ref, kind in ((Ac, "ConstStencilOperator"), (Av, "GridStencilOperator"),
                      (Av.tocsr(), "CSROperator"),
                      (krylov_tpu.as_operator(np.eye(4)), "MatrixOperator"),
                      (jst.poisson_1d(9), "BandedOperator")):
        port = convert.from_reference(ref, device="cpu")
        assert type(port).__name__ == kind
        assert profiling.spmv_traffic_model(port) == jprofiling.spmv_traffic_model(ref), kind
    assert profiling.spmv_traffic_model(convert.from_reference(Ac, device="cpu")) == 2 * n * 4
    assert profiling.spmv_traffic_model(convert.from_reference(Av, device="cpu")) == 7 * n * 4
    assert profiling.spmv_traffic_model(kt.as_operator(np.eye(4), "cpu")) == (16 + 8) * 8


@pytest.mark.parametrize("data_dtype,value_bytes", [(None, 4), (torch.bfloat16, 2)])
def test_pet_traffic_is_the_csr_kernels_own(data_dtype, value_bytes):
    """K10's bytes: values and int32 columns per entry, int32 row pointers,
    float32 x read once and y written once (8 nnz + 12 n in float32, 6 nnz
    + 12 n with bfloat16 values); a symmetric reorder adds its two gathers
    (int64 index, source and destination: 32 n)."""
    sp = scipy.sparse.random(500, 500, density=0.02, random_state=1, format="csr",
                             dtype=np.float32) + scipy.sparse.eye(500, dtype=np.float32)
    A = PETOperator.from_scipy(sp, data_dtype=data_dtype, device="cpu")
    n, nnz = 500, sp.nnz
    assert profiling.spmv_traffic_model(A) == (value_bytes + 4) * nnz + 12 * n
    R = PETOperator.from_scipy(sp, data_dtype=data_dtype, reorder="rcm", device="cpu")
    assert profiling.spmv_traffic_model(R) == (value_bytes + 4) * nnz + 12 * n + 32 * n


def test_timed_solve_and_roofline_report():
    A = st.poisson_2d(8, 8, device="cpu")
    b = torch.ones(64, dtype=torch.float64)
    (sol, info), secs = profiling.timed_solve(kt.cg, A, b, tol=1e-10, maxiter=200)
    assert info.success and secs > 0
    rep = profiling.roofline_report(A, 1e-3)
    want = jprofiling.roofline_report(jst.poisson_2d(8, 8), 1e-3)
    assert set(rep) == set(want)
    assert rep["bytes_ideal"] == want["bytes_ideal"] == 7 * 64 * 8
    for key in ("achieved_gbps", "nnz_per_s"):
        assert rep[key] == pytest.approx(want[key], rel=1e-12)
    assert rep["nnz_per_s"] > 0
    # no published bandwidth for the CPU: the share is not a number
    assert math.isnan(rep["peak_gbps"]) and math.isnan(rep["fraction_of_roofline"])


def test_peak_gbps_by_card_name(monkeypatch):
    """Exact names, the longest matching prefix, unknown cards and the CPU."""
    name = {"value": None}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name["value"])
    card = torch.device("cuda", 0)
    for kind, want in (("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
                       ("NVIDIA H200 NVL", 4800.0)):
        name["value"] = kind
        assert profiling.peak_gbps(card) == want
    name["value"] = "Tesla V100-SXM2-16GB"
    assert math.isnan(profiling.peak_gbps(card))
    assert math.isnan(profiling.peak_gbps("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert math.isnan(profiling.peak_gbps())


def test_sync_reads_back_the_first_tensor():
    A = st.poisson_2d(4, 4, device="cpu")
    out = kt.cg(A, torch.ones(16, dtype=torch.float64), tol=1e-30, maxiter=2)
    assert out[0] is None  # unconverged: the first tensor is info.xk
    assert profiling.sync(out) == float(out[1].xk.sum())
    z = torch.tensor([1 + 2j, 3 - 1j])
    assert profiling.sync(z) == 4.0
    with pytest.raises(TypeError):
        profiling.sync((None, 3))


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the host's operators; the file is the
    Chrome-format JSON that Perfetto and TensorBoard's profiler plugin load."""
    A = st.poisson_2d(16, 16, device="cpu")
    with profiling.trace(str(tmp_path)) as logdir:
        kt.cg(A, torch.ones(256, dtype=torch.float64), tol=1e-8, maxiter=50)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_traffic_model_takes_a_dtype():
    """``dtype`` overrides the operator's item size, as numpy, JAX or torch
    dtypes alike."""
    A = st.poisson_2d(4, 6, dtype=np.float32, device="cpu")
    for dt in (np.float64, jnp.float64, torch.float64):
        assert profiling.spmv_traffic_model(A, dtype=dt) == 7 * 24 * 8
    assert profiling.spmv_traffic_model(A) == 7 * 24 * 4
