#!/usr/bin/env python3
"""Weak scaling of the port's sharded CG, one NCCL rank a GPU (krylov_tpu_torch).

The twin of ``tools/weak_scaling.py``: the same flags, the same fixed-step
problems (2-D Poisson on the grid, PET or BSR route, ``tol=0``, ``--iters``
steps), run under ``torchrun``::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/torch_weak_scaling.py --rows-per-device 4194304 --iters 500

Each rank owns ``rows_per_device`` rows (a multiple of ``--ny``), so the
problem grows with the rank count.  Every rank builds the global operator
on the host and ``sharded_solve`` takes its slab.  After one solve to warm
up, ``--repeats`` timed solves of each route alternate: ``host``, the
host-stepped loop (``_driver._host_stepped``), and ``rule``, the
``while_loop`` driver's own choice (on CUDA the graph route and its cost
rule, which captures each solve anew).  Rank 0 prints, for each route, one
JSON line with the reference's keys (``s_per_iter`` is the median solve's)
and ``route``, ``captured`` (whether the rule's solves captured),
``nccl_graphs`` (``parallel.solve.nccl_graphs()``: several NCCL ranks on
the graph route, with ``--nccl-graphs`` and ``NCCL_GRAPH_MIXING_SUPPORT=0``),
``s_per_iter_all`` (every repeat), ``graph_s`` (the last solve's seconds
of host steps, decisions, capture, instantiation and replays, and its
plan, from ``_driver.LAST_GRAPH``), ``bit_equal`` (every solve of the
route bit-equal, iterate and history, to the host-stepped loop's first;
``--route both`` only) and ``card`` (``nvidia-smi``'s name and power
limit).  ``--replace-every`` sets ``cg_pipelined``'s and ``cg_block``'s
periodic residual replacement (it runs inside the captured steps when it
is below ``--iters``).

``--device cpu --small`` rehearses it on gloo ranks on the CPU.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out[torch.cuda.current_device()] if out else "nvidia-smi printed nothing"


def problem(args, n_dev, kt, parallel, st):
    """``(A, b, N, nnz)``: the reference's problem for ``n_dev`` ranks."""
    ny = args.ny
    rows_per_dev = args.rows_per_device // ny * ny  # multiple of ny
    nx = (rows_per_dev * n_dev) // ny
    N = nx * ny
    rng = np.random.default_rng(0)
    if args.operator == "grid":
        A = st.poisson_2d(nx, ny, dtype=np.float32, device="cpu")
        nnz = int(A.nnz)
    elif args.operator == "csr_pet":
        import scipy.sparse

        sp = scipy.sparse.diags([-1.0, -1.0, 4.0, -1.0, -1.0], [-ny, -1, 0, 1, ny],
                                shape=(N, N), format="csr", dtype=np.float32)
        nnz = int(sp.nnz)
        A = parallel.partition_pet(sp, n_dev)
    else:  # bsr: block-tridiagonal, 8x8 dense blocks
        import scipy.sparse

        from krylov_tpu_torch.ops.bsr import BSROperator

        bs = 8
        blocks = scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(N // bs, N // bs),
                                    format="csr")
        sp = scipy.sparse.kron(blocks, np.eye(bs) + 0.05).tocsr().astype(np.float32)
        nnz = int(sp.nnz)
        A = BSROperator.from_scipy(sp, blocksize=(bs, bs), device="cpu")
    shape = (N, args.block_rhs) if args.solver == "cg_block" else (N,)
    b = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    return A, b, N, nnz


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows-per-device", type=int, default=1 << 22)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--ny", type=int, default=4096)
    p.add_argument("--solver", default="cg", choices=["cg", "cg_pipelined", "cg_block"])
    p.add_argument("--block-rhs", type=int, default=4, help="RHS columns for --solver cg_block")
    p.add_argument("--operator", default="grid", choices=["grid", "csr_pet", "bsr"])
    p.add_argument("--route", default="both", choices=["host", "rule", "both"])
    p.add_argument("--repeats", type=int, default=3, help="timed solves of each route")
    p.add_argument("--replace-every", type=int, default=None,
                   help="cg_pipelined's and cg_block's replace_every (their default if unset)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--nccl-graphs", action="store_true",
                    help="several NCCL ranks take the graph route (parallel.solve.NCCL_GRAPHS; "
                    "needs NCCL_GRAPH_MIXING_SUPPORT=0), to check it")
    p.add_argument("--small", action="store_true",
                   help="rehearsal sizes: 4096 rows a rank, ny 64, 20 steps")
    args = p.parse_args(argv)
    if args.small:
        args.rows_per_device, args.ny, args.iters = 4096, 64, 20

    import torch.distributed as dist

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _driver, parallel
    from krylov_tpu_torch.ops import stencil as st

    if args.device == "cpu":
        kt.set_default_device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("torch_weak_scaling: needs CUDA devices (or --device cpu)")
    parallel.multihost.initialize()
    parallel.solve.NCCL_GRAPHS = args.nccl_graphs
    mesh = parallel.multihost.global_mesh()
    n_dev = mesh.shape[parallel.ROWS]
    A, b, N, nnz = problem(args, n_dev, kt, parallel, st)
    solver = getattr(kt, args.solver)
    card = card_line() if mesh.device.type == "cuda" else "cpu"

    kw = {}
    if args.replace_every is not None and args.solver != "cg":
        kw["replace_every"] = args.replace_every

    def solve():
        return parallel.sharded_solve(solver, A, b, mesh=mesh, tol=0.0, atol=0.0,
                                      maxiter=args.iters, **kw)[1]

    routes = ["host", "rule"] if args.route == "both" else [args.route]
    times = {r: [] for r in routes}
    captured = {r: 0 for r in routes}
    equal = {r: True for r in routes}
    parts = {r: None for r in routes}
    first = None  # the host-stepped loop's first iterate and history
    for rep in range(args.repeats + 1):  # the first of each route warms it
        for r in routes:
            ctx = _driver._host_stepped() if r == "host" else contextlib.nullcontext()
            _driver.reset_counts()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            dist.barrier(group=mesh.group())
            t0 = time.perf_counter()
            with ctx:
                info = solve()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert int(info.numsteps) == args.iters, (int(info.numsteps), args.iters)
            got = (info.xk.cpu(), np.asarray(info.resnorms))
            if r == "host" and first is None:
                first = got
            elif first is not None:
                equal[r] = equal[r] and bool(torch.equal(got[0], first[0])
                                             and np.array_equal(got[1], first[1]))
            if rep:
                times[r].append(dt)
                captured[r] += _driver.COUNTS["captures"]
                last = _driver.LAST_GRAPH
                parts[r] = None if r == "host" or not last else dict(
                    {k: last.get(k) for k in ("host_steps_s", "decide_s", "capture_s",
                                              "instantiate_s", "replays_s", "host_steps")},
                    plan=last.get("plan"))
    work = nnz * (args.block_rhs if args.solver == "cg_block" else 1)
    if dist.get_rank() == 0:
        for r in routes:
            per_iter = float(np.median(times[r])) / args.iters
            print(json.dumps({
                "metric": f"weak_scaling_{args.solver}"
                + ("" if args.operator == "grid" else f"_{args.operator}"),
                "solver": args.solver, "operator": args.operator, "devices": n_dev,
                "processes": dist.get_world_size(), "n_rows": N, "nnz": work,
                "iters": args.iters, "s_per_iter": per_iter,
                "nnz_per_s": work / per_iter, "nnz_per_s_per_device": work / per_iter / n_dev,
                "route": r, "captured": captured[r] > 0,
                "nccl_graphs": parallel.solve.nccl_graphs(),
                "s_per_iter_all": [t / args.iters for t in times[r]], "graph_s": parts[r],
                "bit_equal": equal[r] if first is not None else None, "card": card,
            }), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
