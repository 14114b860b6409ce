#!/usr/bin/env python3
"""Where the time of one CG iteration goes on the GPU (krylov_tpu_torch).

Runs ``cg`` (while_loop backend) and ``cg_stencil(fused=True)`` on
``poisson_2d(n)`` float32 and prints, per solver, the wall time per
iteration of an unprofiled solve, the device time per iteration by kernel
from ``torch.profiler`` (CUDA kernel events only), and the device's idle
share, 1 - device busy / unprofiled wall.  Both per-iteration figures
include the solve's setup spread over the iterations.  Needs one CUDA
device:

    python3 tools/torch_cg_profile.py [--n 4096] [--iters 50]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_cg_profile: needs a CUDA device")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch.ops import stencil as st

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    A = st.poisson_2d(args.n, dtype=np.float32, device=dev)
    b = torch.ones(A.grid, device=dev)
    solvers = {
        "cg": lambda: kt.cg(A, b, inner=lambda u, v: torch.sum(u * v), tol=0.0,
                            atol=0.0, maxiter=args.iters, backend="while_loop"),
        "cg_stencil fused": lambda: kt.cg_stencil(
            A, b, tol=0.0, atol=0.0, maxiter=args.iters, fused=True),
    }
    for name, solve in solvers.items():
        solve()  # warm up: kernel build, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(r[1] for r in rows) * 1e-6
        print(f"[{card}] {name} poisson_2d({args.n}) f32, {args.iters} iterations: "
              f"wall {wall / args.iters * 1e6:.1f} us/iter, device busy "
              f"{busy / args.iters * 1e6:.1f} us/iter, idle share {1 - busy / wall:.3f}")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
            print(f"    {us / args.iters:9.1f} us/iter  {count / args.iters:5.2f}/iter  "
                  f"{key[:90]}")


if __name__ == "__main__":
    main()
