#!/usr/bin/env python3
"""What the distribution layer costs at one rank on the GPU (krylov_tpu_torch).

Starts a world of one rank on NCCL (``parallel.make_mesh``) and prints, by
host clock around loops that end in a synchronize (the solves are
host-bound, so the host's time per call is what they pay): an
``all_reduce`` of a scalar straight through ``torch.distributed`` and
through ``Mesh.all_reduce`` (which launches nothing on a rank alone), the
grid operator's matvec at ``n^2`` single and as the one-rank slab
(``ShardedGridStencilOperator``), and ``cg`` single and through
``sharded_solve`` (µs a step, the median and spread of ``--repeats``
solves of each, alternating), on the host-stepped loop and on the route
the ``while_loop`` driver picks, with the collectives a step the mesh
launched; each beside the card's name and power limit.  Run it beside
another checkout's copy (``git archive``) in one call to see what a change
of the distribution layer removed, or twice to see what an environment
variable of NCCL changes, e.g. with ``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` (the
flight recorder off).  Needs one CUDA device:

    python3 tools/torch_collective_cost.py [--n 4096] [--steps 200] [--repeats 5]
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def per_call_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_collective_cost: needs a CUDA device")
    import torch.distributed as dist

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _driver, parallel
    from krylov_tpu_torch.parallel import mesh as pm
    from krylov_tpu_torch.ops import stencil as st

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    env = {k: v for k, v in os.environ.items() if k.startswith(("NCCL_", "TORCH_NCCL_"))}
    print(f"[{card}] torch {torch.__version__} nccl {torch.cuda.nccl.version()} env {env}")
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh(device=dev)
    try:
        one = torch.ones((), dtype=torch.float32, device=dev)
        group = mesh.group()
        raw = per_call_us(lambda: dist.all_reduce(one.clone(), group=group), 500)
        wrapped = per_call_us(lambda: mesh.all_reduce(one), 500)
        A = st.poisson_2d(args.n, dtype=np.float32, device=dev)
        A_l = parallel.ShardedGridStencilOperator(A.coeffs2d, A.offsets, A.ny, mesh,
                                                  hermitian=True)
        x = torch.ones(A.grid, dtype=torch.float32, device=dev)
        mv, mv_l = per_call_us(lambda: A @ x, 100), per_call_us(lambda: A_l @ x, 100)
        print(f"  all_reduce of a scalar: {raw:.1f} us a call through torch.distributed, "
              f"{wrapped:.1f} through Mesh.all_reduce")
        print(f"  matvec at {args.n}^2: {mv:.1f} us single, {mv_l:.1f} us the one-rank slab")

        def inner(u, v):
            return torch.sum(u * v)

        runs = {
            "single": lambda it: kt.cg(A, x, inner=inner, tol=0.0, atol=0.0, maxiter=it,
                                       backend="while_loop"),
            "sharded": lambda it: parallel.sharded_solve(kt.cg, A, x, mesh=mesh, tol=0.0,
                                                         atol=0.0, maxiter=it),
        }
        routes = {"host-stepped": _driver._host_stepped, "rule": contextlib.nullcontext}
        us = {(n, r): [] for n in runs for r in routes}
        coll = {}
        for name, run in runs.items():
            run(5)
        for rep in range(args.repeats):
            for key in list(us)[::1 if rep % 2 == 0 else -1]:
                name, route = key
                torch.cuda.synchronize()
                pm.reset_counts()
                _driver.reset_counts()
                t0 = time.perf_counter()
                with routes[route]():
                    runs[name](args.steps)
                torch.cuda.synchronize()
                us[key].append((time.perf_counter() - t0) / args.steps * 1e6)
                coll[key] = (sum(pm.COUNTS.values()) / args.steps, _driver.COUNTS["captures"])
        for (name, route), v in us.items():
            print(f"  cg {name}, {route}: {np.median(v):.1f} us a step (spread "
                  f"{max(v) - min(v):.1f}, {args.repeats} solves), "
                  f"{coll[name, route][0]:.2f} collectives a step, captures "
                  f"{coll[name, route][1]}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
