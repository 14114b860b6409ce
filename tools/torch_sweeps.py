#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` alone on one NVIDIA GPU, or S1's and S2's
tuning constants timed.

    python3 tools/torch_sweeps.py                 # phase 8: the stationary path
    python3 tools/torch_sweeps.py --variants KRYLOV_SWEEP_PER_MIN=4,8,16
    python3 tools/torch_sweeps.py --trace         # where a sweep step's device time goes

Phase 8: S1 and S2 (the triangular-sweep kernels) against their plain
versions, timed, and the sweep solvers at full width on the rule's route
against the host-stepped loop; it prints what phase 8 prints, then the
launches it counted and S1's and S2's errors and timing records as one
JSON line.  ``--variants NAME=v1,v2,...`` builds ``csrc/`` once for each
value (``_build.build(defines=...)``) and times S1 (poisson_2d at 4096^2
and 1024^2, float32, lower) and S2 (ILU(0) at 256^2 and 1024^2) with each,
by CUDA events, every result held to the default build's bit for bit or
to the plain loop.  Run from the root of the repository; the card's name
and power limit head and end the output.
"""

import argparse
import ctypes
import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def variants(spec, smoke, card):
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_triangular as ct
    from krylov_tpu_torch.ops import stencil as st
    from krylov_tpu_torch.ops.triangular import GridLowerSweep

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cases = []
    for n in (4096, 1024):
        A = st.poisson_2d(n, dtype=np.float32, device=dev)
        cases.append((f"S1 lower {n}^2", GridLowerSweep(A.coeffs2d, A.row_offsets, A.col_offsets),
                      torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev),
                      n))
    for g in (256, 1024):
        M = kt.ILUPreconditioner.from_scipy(smoke.grid_csr(g, 0.5, 0.4), device=dev)
        cases.append((f"S2 ILU(0) L {g}^2", M._l,
                      torch.from_numpy(rng.standard_normal(g * g).astype(np.float32)).to(dev),
                      M._l.nlevels))
    want = [sweep(b) for _, sweep, b, _ in cases]
    name, values = spec.split("=")
    default = ct._lib
    for v in [None] + values.split(","):
        defines = () if v is None else (f"{name}={v}",)
        path, seconds, _ = _build.build(defines)
        lib = ct.bind(ctypes.CDLL(str(path)))
        ct._lib = lambda lib=lib: lib
        for (label, sweep, b, chain), ref in zip(cases, want):
            got = sweep(b)
            same = torch.equal(got, ref)
            err = float((got - ref).abs().max())
            ms = smoke.time_ms(lambda: sweep(b), 10)
            print(f"  [{card}] {defines or 'default'} {label}: {ms * 1e3:.1f} us "
                  f"({ms * 1e3 / chain:.3f} us a row or level), bit-equal to the default "
                  f"build {same}, max abs difference {err:.3e} (built in {seconds:.1f} s)",
                  flush=True)
    ct._lib = default


def trace(smoke, card):
    """Where a sweep step's device time goes: ``profiling.trace`` around
    three ``gauss_seidel`` steps at 4096^2 and around an ILU(0) application
    at 1024^2, each trace summed by kernel, and the same calls under a
    profiler of the device's activity alone (``chip_smoke.device_busy``'s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import profiling
    from krylov_tpu_torch.ops import stencil as st

    dev = torch.device("cuda", 0)
    A = st.poisson_2d(4096, dtype=np.float32, device=dev)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(4096 * 4096).astype(
        np.float32)).to(dev)
    M = kt.ILUPreconditioner.from_scipy(smoke.grid_csr(1024, 0.5, 0.4), device=dev)
    r = b[:1024 * 1024].clone()
    cases = {
        "gauss_seidel, 3 steps at 4096^2": lambda: kt.gauss_seidel(
            A, b, tol=1e-30, maxiter=3, backend="while_loop"),
        "one ILU(0) application at 1024^2": lambda: M @ r,
    }
    out = tempfile.mkdtemp(prefix="sweeps_trace_")  # the traces, removed once summed
    for label, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        for what, activities in (("CPU and CUDA activity", [ProfilerActivity.CPU,
                                                            ProfilerActivity.CUDA]),
                                 ("CUDA activity alone", [ProfilerActivity.CUDA])):
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = [(e.key, e.self_device_time_total, e.count)
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            show(card, f"{label}, {what}", wall, rows)
        # the Chrome trace profiling.trace writes, its kernel events summed
        before = set(glob.glob(os.path.join(out, "*.json")))
        with profiling.trace(out):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (path,) = set(glob.glob(os.path.join(out, "*.json"))) - before
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        by = {}
        for e in events:
            us, c = by.get(e["name"], (0.0, 0))
            by[e["name"]] = (us + e["dur"], c + 1)
        show(card, f"{label}, profiling.trace ({os.path.getsize(path)} bytes)", wall,
             [(k, us, c) for k, (us, c) in by.items()])
    shutil.rmtree(out)


def show(card, what, wall, rows):
    busy = sum(q[1] for q in rows) * 1e-3
    print(f"  [{card}] {what}: wall {wall * 1e3:.2f} ms, device {busy:.2f} ms in "
          f"{sum(q[2] for q in rows)} kernels; by kernel: " + "; ".join(
              f"{k[:48]} x{c} {us / 1e3:.3f} ms"
              for k, us, c in sorted(rows, key=lambda q: -q[1])[:5]), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweeps: no CUDA device")
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", action="append", default=[],
                        help="NAME=v1,v2,...: build csrc/ with each value and time S1 and S2")
    parser.add_argument("--trace", action="store_true",
                        help="profile a gauss_seidel solve and an ILU(0) application")
    args = parser.parse_args()
    import chip_smoke as smoke
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    path, seconds, _ = _build.build()
    smoke.log(f"{card}; kernels built in {seconds:.1f} s -> {path.name}")
    if args.variants or args.trace:
        for spec in args.variants:
            variants(spec, smoke, card)
        if args.trace:
            trace(smoke, card)
    else:
        t0 = time.perf_counter()
        launches, errs, times = smoke.phase_stationary(torch.device("cuda", 0), kt, cs, sv, st,
                                                       card)
        smoke.log(f"phase 8: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"launches": launches, "errs": errs, "times": times}), flush=True)
    smoke.log(card)


if __name__ == "__main__":
    main()
