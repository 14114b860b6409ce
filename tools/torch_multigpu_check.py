#!/usr/bin/env python3
"""The distribution layer across GPUs, one rank a GPU on NCCL (krylov_tpu_torch).

Run under ``torchrun``, as a user's sharded solve runs: every rank calls
``parallel.multihost.initialize()`` (the process group from ``torchrun``'s
environment: NCCL for CUDA tensors) and ``multihost.global_mesh()``, then
the solves of ``chip_smoke.py`` 11b (``chip_smoke.sharded_cases``: the
grid operator with ``M_diag`` and the shard monitor, the const stencil
alone and under ``ChebyshevPreconditioner``, CSR in halo and gather mode,
PET ``qmr`` and an ``(N, 8)`` b, 6c's block matrix, restarted ``gmres``,
``make_sharded_solver`` on three right-hand sides, one built solver a
route, which keeps the graph of its first capture) and 12b
(``chip_smoke.partition_cases``: ``multigrid_factory`` in its three
couplings and on the Galerkin path, ``partition_amg`` with two sharded
levels and Chebyshev smoothing, ``partition_ilu0`` under ``qmr``,
``partition_block_jacobi``), and with four ranks
``cg`` on two right-hand-side columns over a 2 x 2 mesh (``shard_rhs``).
Every case runs on three routes of the ``while_loop`` driver: the
host-stepped loop, a capture forced after three host steps
(``_driver._capture_at``; its plain twin on the CPU) and the route the
cost rule picks.  Every rank holds each route bit for bit to its
host-stepped run, with the same kernel launches and collectives, checks
that it launched the kernel and staged nothing through the host, and that
all ranks hold the same iterate; rank 0 holds the host-stepped result to
the same solve on its one device (the f32 band of ``chip_smoke.py``).
Prints the card line and, for each route, the wall time of each sharded
solve, its captures and what kept it on the host.

    python -m torch.distributed.run --standalone --nproc-per-node 4 tools/torch_multigpu_check.py

``--device cpu --small`` rehearses it on gloo ranks on the CPU.
"""

import argparse
import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="rehearsal sizes")
    ap.add_argument("--nccl-graphs", action="store_true",
                    help="several NCCL ranks take the graph route (parallel.solve.NCCL_GRAPHS; "
                    "needs NCCL_GRAPH_MIXING_SUPPORT=0), to check it")
    args = ap.parse_args()
    import torch.distributed as dist

    import chip_smoke as cm
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _driver, parallel
    from krylov_tpu_torch.ops import cuda_bsr, cuda_spmv, cuda_stencil
    from krylov_tpu_torch.ops import stencil as st
    from krylov_tpu_torch.parallel import mesh as pm

    if args.device == "cpu":
        kt.set_default_device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("torch_multigpu_check: needs CUDA devices (or --device cpu)")
    if args.small:
        cm.GLOO_N, cm.GLOO_NPG, cm.NBLK = 64, 64, 64
    parallel.multihost.initialize()
    parallel.solve.NCCL_GRAPHS = args.nccl_graphs
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = parallel.multihost.global_mesh()
    dev = mesh.device
    lead = rank == 0
    if lead:
        card = cm.card_line() if dev.type == "cuda" else "cpu"
        cm.log(f"[{card}] {world} ranks, backend {dist.get_backend()}, torch "
               f"{torch.__version__}, rank 0 on {dev}, several NCCL ranks on the "
               f"graph route: {parallel.solve.nccl_graphs()}")
    cases, (A_small, A_small_d, bs, fixed) = cm.sharded_cases(dev, kt, cuda_spmv, st, world)
    rng = np.random.default_rng(cm.SEED + 92)
    B = rng.standard_normal((A_small.shape[0], 2)).astype(np.float32)
    runs = [(label, kernel, args_, kw, ref) for label, kernel, args_, kw, ref in cases]
    runs += cm.partition_cases(dev, kt, cuda_spmv, st, world)
    runs += [(f"make_sharded_solver, right-hand side {j}", "stencil2d_matvec",
              (kt.cg, A_small, b), dict(fixed, build=True),
              lambda b=b: cm.single_solve(kt.cg, A_small_d, b, dev, **fixed))
             for j, b in enumerate(bs)]
    if world == 4:
        # split columns leave the grid path for the flat banded one (no K1)
        runs.append(("cg, two columns over a 2 x 2 mesh (shard_rhs)", None,
                     (kt.cg, A_small, B), dict(fixed, mesh_rhs=2, shard_rhs=True),
                     lambda: cm.single_solve(kt.cg, A_small_d, B, dev, **fixed)))
    # the three routes of every case: the host-stepped loop, a capture
    # forced after three host steps (its plain twin on the CPU), the rule
    forced = _driver._capture_at if dev.type == "cuda" else _driver._plain_graph
    routes = {"host-stepped": _driver._host_stepped, "forced": lambda: forced(3, 4, 8),
              "rule": contextlib.nullcontext}
    mods = (cuda_stencil, cuda_spmv, cuda_bsr)
    solvers = {}
    for label, kernel, (solver, A, b), kw, ref_fn in runs:
        kw = dict(kw)
        calls = []
        if kw.pop("record", False):
            kw["callback"] = lambda k, rn: calls.append(k)
        mesh_rhs = kw.pop("mesh_rhs", 1)
        run_mesh = mesh if mesh_rhs == 1 else parallel.make_mesh(n_rhs=mesh_rhs)
        build = kw.pop("build", False)
        got = {}
        for route, ctx in routes.items():
            calls.clear()
            for mod in mods:
                mod.reset_launches()
            pm.reset_counts()
            _driver.reset_counts()
            _driver.LAST_GRAPH.clear()
            t0 = time.perf_counter()
            with ctx():
                if build:
                    # one built solver a route: the first right-hand side's run
                    # captures the graph it keeps, the later ones replay it
                    if (id(A), route) not in solvers:
                        solvers[id(A), route] = parallel.make_sharded_solver(
                            solver, A, mesh=run_mesh, **kw)
                    _, info = solvers[id(A), route](b)
                else:
                    _, info = parallel.sharded_solve(solver, A, b, mesh=run_mesh, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v for k, v in {**cuda_stencil.LAUNCHES, **cuda_spmv.LAUNCHES,
                                          **cuda_bsr.LAUNCHES}.items() if v}
            if dev.type == "cuda":
                assert kernel is None or launched.get(kernel, 0) > 0, (rank, label, route)
                assert sum(pm.STAGED.values()) == 0, (rank, label, pm.STAGED)
            digest = torch.tensor([float(info.xk.double().sum()),
                                   float(info.xk.double().abs().max())],
                                  dtype=torch.float64, device=dev)
            every = [torch.empty_like(digest) for _ in range(world)]
            dist.all_gather(every, digest)
            assert all(torch.equal(d, digest) for d in every), (rank, label, route)
            if calls or kw.get("callback"):
                assert (len(calls) > 0) == (mesh.coord[parallel.ROWS] == 0), (rank, label)
                assert not calls or len(calls) == info.numsteps + 1, (rank, label)
            last = _driver.LAST_GRAPH
            parts = "/".join(f"{last.get(k, 0.0) * 1e3:.1f}" for k in (
                "host_steps_s", "capture_s", "instantiate_s", "replays_s")
            ) if _driver.COUNTS["graph_route"] else "-"
            got[route] = (info, launched, dict(pm.COUNTS), dict(_driver.COUNTS),
                          last.get("uncapturable"), wall, parts, last.get("kept"))
        ref_info, ref_launched, ref_coll = got["host-stepped"][:3]
        for route, (info, launched, coll, counts, read, wall, *_) in got.items():
            same = (info.numsteps == ref_info.numsteps and info.success == ref_info.success
                    and np.array_equal(info.resnorms, ref_info.resnorms)
                    and torch.equal(info.xk, ref_info.xk))
            assert same and launched == ref_launched and coll == ref_coll, (
                rank, label, route, launched, ref_launched, coll, ref_coll)
        if lead:
            ref = ref_fn()
            cm.sharded_held(f"{label}", (ref_info.numsteps, ref_info.resnorms), ref,
                            ref_info.xk.cpu().numpy(), ref.xk.cpu().numpy())
            for route, (info, launched, coll, counts, read, wall, cap, kept) in got.items():
                cm.log(f"    {route}: {wall * 1e3:.1f} ms, bit-equal to the host-stepped loop "
                       f"with the same launches and collectives; graph route "
                       f"{counts['graph_route']}, captures {counts['captures']} (ms of host "
                       f"steps / capture / instantiation / replays: {cap}), steps replayed "
                       f"{counts['graph_steps']}, uncapturable {counts['uncapturable']}"
                       + (f" ({read})" if read else "") + f", meetings {counts['meetings']}"
                       + (f", kept graph: {kept}" if build else ""))
    # the built solvers' kept graphs hold captured collectives: they go
    # before the process group does
    solvers.clear()
    gc.collect()
    dist.barrier()
    if lead:
        cm.log(f"all {len(runs)} sharded solves held on {world} ranks")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
