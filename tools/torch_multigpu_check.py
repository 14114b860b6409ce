#!/usr/bin/env python3
"""The distribution layer across GPUs, one rank a GPU on NCCL (krylov_tpu_torch).

Run under ``torchrun``, as a user's sharded solve runs: every rank calls
``parallel.multihost.initialize()`` (the process group from ``torchrun``'s
environment: NCCL for CUDA tensors) and ``multihost.global_mesh()``, then
the solves of ``chip_smoke.py`` 11b (``chip_smoke.sharded_cases``: the
grid operator with ``M_diag`` and the shard monitor, the const stencil
alone and under ``ChebyshevPreconditioner``, CSR in halo and gather mode,
PET ``qmr`` and an ``(N, 8)`` b, 6c's block matrix, restarted ``gmres``,
``make_sharded_solver`` on three right-hand sides) and 12b
(``chip_smoke.partition_cases``: ``multigrid_factory`` in its three
couplings and on the Galerkin path, ``partition_amg`` with two sharded
levels and Chebyshev smoothing, ``partition_ilu0`` under ``qmr``,
``partition_block_jacobi``), and with four ranks
``cg`` on two right-hand-side columns over a 2 x 2 mesh (``shard_rhs``).
Rank 0 holds each result to the same solve on its one device (the f32
band of ``chip_smoke.py``); every rank checks that it launched the kernel
and staged nothing through the host, and that all ranks hold the same
iterate.  Prints the card line and the wall time of each sharded solve.

    python -m torch.distributed.run --standalone --nproc-per-node 4 tools/torch_multigpu_check.py

``--device cpu --small`` rehearses it on gloo ranks on the CPU.
"""

import argparse
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
    args = ap.parse_args()
    import torch.distributed as dist

    import chip_smoke as cm
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import parallel
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
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = parallel.multihost.global_mesh()
    dev = mesh.device
    lead = rank == 0
    if lead:
        card = cm.card_line() if dev.type == "cuda" else "cpu"
        cm.log(f"[{card}] {world} ranks, backend {dist.get_backend()}, torch "
               f"{torch.__version__}, rank 0 on {dev}")
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
    solvers = {}
    for label, kernel, (solver, A, b), kw, ref_fn in runs:
        kw = dict(kw)
        calls = []
        if kw.pop("record", False):
            kw["callback"] = lambda k, rn: calls.append(k)
        mesh_rhs = kw.pop("mesh_rhs", 1)
        run_mesh = mesh if mesh_rhs == 1 else parallel.make_mesh(n_rhs=mesh_rhs)
        build = kw.pop("build", False)
        for mod in (cuda_stencil, cuda_spmv, cuda_bsr):
            mod.reset_launches()
        pm.reset_counts()
        t0 = time.perf_counter()
        if build:
            if id(A) not in solvers:
                solvers[id(A)] = parallel.make_sharded_solver(solver, A, mesh=run_mesh, **kw)
            _, info = solvers[id(A)](b)
        else:
            _, info = parallel.sharded_solve(solver, A, b, mesh=run_mesh, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {**cuda_stencil.LAUNCHES, **cuda_spmv.LAUNCHES, **cuda_bsr.LAUNCHES}
        if dev.type == "cuda":
            assert kernel is None or launched[kernel] > 0, (rank, label)
            assert sum(pm.STAGED.values()) == 0, (rank, label, pm.STAGED)
        digest = torch.tensor([float(info.xk.double().sum()), float(info.xk.double().abs().max())],
                              dtype=torch.float64, device=dev)
        every = [torch.empty_like(digest) for _ in range(world)]
        dist.all_gather(every, digest)
        assert all(torch.equal(d, digest) for d in every), (rank, label)
        if lead:
            ref = ref_fn()
            cm.sharded_held(f"{label} ({wall * 1e3:.1f} ms)", (info.numsteps, info.resnorms),
                            ref, info.xk.cpu().numpy(), ref.xk.cpu().numpy())
            if calls:
                assert len(calls) == info.numsteps + 1, label
        if calls or kw.get("callback"):
            assert (len(calls) > 0) == (mesh.coord[parallel.ROWS] == 0), (rank, label)
    dist.barrier()
    if lead:
        cm.log(f"all {len(runs)} sharded solves held on {world} ranks")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
