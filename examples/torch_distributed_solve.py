"""Row-partitioned solve over the ranks of a process group (PyTorch port).

One GPU (a world of one rank, started by ``make_mesh``):

    python examples/torch_distributed_solve.py [--n 128] [--device cuda]

Several GPUs on one host, one rank a GPU on NCCL:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        examples/torch_distributed_solve.py

The twin of ``examples/distributed_solve.py``; several hosts set
``torchrun``'s rendezvous the same way (``multihost.initialize`` reads it).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import torch

import krylov_tpu_torch as krylov
from krylov_tpu_torch import parallel
from krylov_tpu_torch.ops import stencil


def world_size():
    """The ranks of the process group: ``torchrun``'s (started here from
    its environment), one already running, or 1 without either."""
    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        parallel.multihost.initialize()
    return dist.get_world_size() if dist.is_initialized() else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128, help="grid columns")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.device is not None:
        krylov.set_default_device(args.device)
    world = world_size()
    ny = args.n
    nx = 16 * world  # rows divide evenly over the mesh
    A = stencil.poisson_2d(nx, ny, dtype=np.float32, device="cpu")
    rng = np.random.default_rng(0)
    b = rng.standard_normal(nx * ny).astype(np.float32)

    mesh = parallel.make_mesh()
    M_diag = 1.0 / A.diagonal().numpy()  # Jacobi preconditioner

    sol, info = parallel.sharded_solve(krylov.cg, A, b, mesh=mesh, M_diag=M_diag, tol=1e-5,
                                       maxiter=4000)
    r = b - (A @ info.xk.cpu()).numpy()
    print(f"ranks={world} success={info.success} iters={info.numsteps} "
          f"relres={np.linalg.norm(r) / np.linalg.norm(b):.2e}")
    out = {"solve": info, "steps": []}

    # Build once, solve many: the partition and the transfer of each rank's
    # slab happen a single time; repeated right-hand sides (time stepping,
    # parameter sweeps) skip the set-up sharded_solve pays.  Trajectories
    # are identical.
    run = parallel.make_sharded_solver(krylov.cg, A, mesh=mesh, M_diag=M_diag, tol=1e-5,
                                       maxiter=4000)
    for step in range(3):
        bk = rng.standard_normal(nx * ny).astype(np.float32)
        sol, info = run(bk)
        print(f"  step {step}: iters={info.numsteps} success={info.success}")
        out["steps"].append(info)
    return out


if __name__ == "__main__":
    main()
