"""Profiling and observability (counterpart of ``krylov_tpu.profiling``).

* :func:`trace`: context manager around ``torch.profiler`` writing a
  Chrome-format trace of a solve (CPU and, on a CUDA device, the kernels)
  that Perfetto and TensorBoard's profiler plugin load,
* :func:`timed_solve`: wall-clock a solve, completion forced by a scalar
  readback,
* :func:`spmv_traffic_model` / :func:`roofline_report`: the ideal bytes of
  one matvec per operator type and the achieved share of the card's memory
  bandwidth.
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

# device memory peak bandwidth per card (GB/s), by torch.cuda.get_device_name
PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # NVIDIA H100 datasheet, SXM5: 3.35 TB/s
    "NVIDIA H100 PCIe": 2000.0,  # NVIDIA H100 datasheet, PCIe: 2 TB/s
    "NVIDIA H200": 4800.0,  # NVIDIA H200 datasheet, SXM: 4.8 TB/s
}


def peak_gbps(device=None) -> float:
    """Published memory bandwidth of ``device`` (default: the current CUDA
    device) in GB/s: the :data:`PEAK_GBPS` entry of its name, else the
    longest entry its name starts with; NaN on the CPU or an unknown card."""
    if device is None:
        if not torch.cuda.is_available():
            return float("nan")
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        return float("nan")
    kind = torch.cuda.get_device_name(device)
    if kind in PEAK_GBPS:
        return PEAK_GBPS[kind]
    for k, v in sorted(PEAK_GBPS.items(), key=lambda kv: -len(kv[0])):
        if kind.startswith(k):
            return v
    return float("nan")


@contextlib.contextmanager
def trace(logdir=None):
    """``with profiling.trace() as logdir: solve(...)``: a ``torch.profiler``
    trace of the block (CPU activity, and CUDA activity when a CUDA device
    is present), written on exit to ``logdir`` (default
    ``$TMPDIR/krylov_tpu_torch_trace``) as ``*.pt.trace.json``."""
    logdir = os.path.join(tempfile.gettempdir(), "krylov_tpu_torch_trace") \
        if logdir is None else logdir
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield logdir


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):  # results, (sol, info), Info
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync(x):
    """Force device completion by a scalar readback of the first tensor in
    ``x`` (a tensor, or tuples and ``Info`` holding one)."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"no tensor to read back in {type(x).__name__}")
    s = t.sum()
    return float(s.real if s.is_complex() else s)


def timed_solve(solve_fn, *args, warmup=True, **kwargs):
    """Run ``solve_fn(*args, **kwargs)``, return ``(result, seconds)``;
    completion is forced by :func:`sync` on the result."""
    if warmup:
        sync(solve_fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = solve_fn(*args, **kwargs)
    sync(out)
    return out, time.perf_counter() - t0


def _itemsize(dtype):
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def spmv_traffic_model(A, dtype=None) -> int:
    """Ideal device-memory bytes of one ``A @ x`` for the operator types here.

    * ConstStencilOperator: x read + y write (the weights are constants)
    * Banded/GridStencil: coefficient planes + x + y
    * PETOperator (the CSR kernel K10): values + int32 columns, int32 row
      pointers, x read once, float32 y; with a symmetric reorder, the two
      ``index_select`` gathers (int64 index, source and destination)
    * CSR: data + int32 indices + x (counted once) + y
    * dense: matrix + x + y
    """
    itemsize = _itemsize(dtype or getattr(A, "dtype", np.float32))
    n = A.shape[0]
    kind = type(A).__name__
    if kind == "ConstStencilOperator":
        return 2 * n * itemsize
    if kind == "PETOperator":
        base = A.nnz * (_itemsize(A.dtype) + 4) + 3 * n * 4
        if getattr(A, "_perm", None) is not None:
            base += 2 * n * (8 + 4 + 4)
        return base
    if hasattr(A, "coeffs2d") or hasattr(A, "coeffs"):
        ndiag = A.coeffs2d.shape[0] if hasattr(A, "coeffs2d") else A.coeffs.shape[0]
        return (ndiag + 2) * n * itemsize
    if hasattr(A, "indptr"):  # CSR
        return int(A.nnz) * (itemsize + 4) + 2 * n * itemsize
    return (n * n + 2 * n) * itemsize  # dense


def roofline_report(A, seconds_per_matvec, device=None) -> dict:
    """Achieved bandwidth and share of the bandwidth bound of one matvec
    (``peak_gbps`` is NaN on the CPU, and so is the share)."""
    bytes_ideal = spmv_traffic_model(A)
    gbps = bytes_ideal / seconds_per_matvec / 1e9
    peak = peak_gbps(device)
    return {
        "bytes_ideal": bytes_ideal,
        "achieved_gbps": gbps,
        "peak_gbps": peak,
        "fraction_of_roofline": gbps / peak,
        "nnz_per_s": float(getattr(A, "nnz", 0)) / seconds_per_matvec,
    }
