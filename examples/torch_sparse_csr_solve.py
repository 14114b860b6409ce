"""General-sparsity solves on the PyTorch port: scipy CSR in, the CSR
kernels K10/K11 underneath.

The twin of ``examples/sparse_csr_solve.py``; three ways to reach the
kernels:

1. implicitly: pass a scipy sparse matrix to any solver; on a CUDA device
   large float32 matrices route to :class:`PETOperator` (K10),
2. explicitly: build a :class:`PETOperator` once and reuse it,
3. distributed: :func:`partition_pet` + ``sharded_solve`` run the same
   kernel on row slabs, one rank a GPU (run under ``torchrun`` with two or
   more ranks; skipped otherwise).

    python examples/torch_sparse_csr_solve.py [--n 32768] [--device cuda]
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        examples/torch_sparse_csr_solve.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import scipy.sparse
import torch

import krylov_tpu_torch as krylov
from krylov_tpu_torch import parallel
from krylov_tpu_torch.ops.cuda_spmv import PETOperator


def irregular_spd(n, seed=0):
    """Unstructured SPD test matrix: random couplings, dominant diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), 4)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix((0.3 * rng.standard_normal(rows.shape[0]), (rows, cols)),
                                shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(5.0 + rng.random(n))
    A.sum_duplicates()
    return A.astype(np.float32)


def world_size():
    """The ranks of the process group: ``torchrun``'s (started here from
    its environment), one already running, or 1 without either."""
    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        parallel.multihost.initialize()
    return dist.get_world_size() if dist.is_initialized() else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 15, help="rows")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.device is not None:
        krylov.set_default_device(args.device)
    world = world_size()
    n = args.n
    A = irregular_spd(n)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=krylov.default_device())
    out = {}

    # 1. implicit: solvers accept the scipy matrix directly
    sol, info = krylov.cg(A, b, tol=1e-4, maxiter=200)
    r = np.linalg.norm(A @ info.xk.cpu().numpy() - b.cpu().numpy())
    print(f"cg(scipy csr): success={info.success} steps={info.numsteps} |r|={r:.2e}")
    out["implicit"] = info

    # 2. explicit PET operator: one-time preprocessing, then reuse
    op = PETOperator.from_scipy(A)
    print(f"PET fill={op.fill:.3f} nnz={op.nnz}")
    for solver in (krylov.cg, krylov.bicgstab):
        sol, info = solver(op, b, tol=1e-4, maxiter=300)
        print(f"{solver.__name__}(PETOperator): success={info.success} steps={info.numsteps}")
        out[solver.__name__] = info

    # GS/SOR smoothers also run on large general sparsity
    # (level-scheduled triangular sweeps)
    sol, info = krylov.gauss_seidel(A, b, tol=1e-3, maxiter=30, backend="while_loop")
    print(f"gauss_seidel: success={info.success} steps={info.numsteps}")
    out["gauss_seidel"] = info

    # 3. distributed: row slabs over the ranks
    if world > 1:
        part = parallel.partition_pet(A, world)
        sol, info = parallel.sharded_solve(krylov.cg, part, b.cpu().numpy(),
                                           mesh=parallel.make_mesh(), tol=1e-4, maxiter=200)
        print(f"sharded cg(PET partition, {world} ranks): success={info.success} "
              f"steps={info.numsteps}")
        out["sharded"] = info
    else:
        print("(sharded section skipped: no process group of two or more ranks; run "
              "under torchrun)")
    return out


if __name__ == "__main__":
    main()
