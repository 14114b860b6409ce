"""Tour of the preconditioner suite on the PyTorch port, one hard-ish
problem each.

    python examples/torch_preconditioners.py [--n 48] [--device cuda]   # one GPU
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        examples/torch_preconditioners.py                               # + sharded

The twin of ``examples/preconditioners.py``:

* pointwise Jacobi: free, helps only diagonal scaling;
* block Jacobi: one batched matmul; line blocks kill anisotropy;
* ILU(0): the classic for nonsymmetric systems (gmres/bicgstab/qmr);
* AMG: mesh-independent iteration counts;
* sharded: ``M_partition`` (distributed AMG, ILU-Schwarz) plugs into the
  same ``sharded_solve`` call, with two or more ranks (``torchrun``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import scipy.sparse

import krylov_tpu_torch as krylov
from krylov_tpu_torch import parallel


def poisson2d(n, eps=1.0, pe=0.0, dtype=np.float64):
    """-eps*u_xx - u_yy (+ pe*u_x): anisotropic / convective 2-D grid."""
    h = 1.0 / (n + 1)
    Tx = scipy.sparse.diags([-eps - pe * h / 2, 2 * eps, -eps + pe * h / 2], [-1, 0, 1],
                            shape=(n, n))
    Ty = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = scipy.sparse.identity(n)
    return (scipy.sparse.kron(I, Tx) + scipy.sparse.kron(Ty, I)).tocsr().astype(dtype)


def world_size():
    """The ranks of the process group: ``torchrun``'s (started here from
    its environment), one already running, or 1 without either."""
    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        parallel.multihost.initialize()
    return dist.get_world_size() if dist.is_initialized() else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, help="grid side")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.device is not None:
        krylov.set_default_device(args.device)
    world = world_size()
    rng = np.random.default_rng(0)
    n = args.n
    N = n * n
    out = {}

    # ---- SPD, anisotropic: point vs block (line) Jacobi vs AMG --------
    A = poisson2d(n, eps=100.0)
    b = rng.standard_normal(N)
    _, plain = krylov.cg(A, b, tol=1e-8, maxiter=2000, backend="while_loop")
    _, ptj = krylov.cg(A, b, tol=1e-8, M=krylov.jacobi_preconditioner(A), maxiter=2000,
                       backend="while_loop")
    Mbj = krylov.BlockJacobiPreconditioner.from_scipy(A, block=n)
    _, bj = krylov.cg(A, b, tol=1e-8, M=Mbj, backend="while_loop")
    Mamg = krylov.AMGPreconditioner.from_scipy(A)
    _, amg = krylov.cg(A, b, tol=1e-8, M=Mamg, backend="while_loop")
    print(f"100:1 anisotropic Poisson {n}x{n}  CG iterations: plain: {plain.numsteps}, "
          f"jacobi: {ptj.numsteps}, line-block-jacobi: {bj.numsteps}, amg: {amg.numsteps}")
    out.update(plain=plain, jacobi=ptj, block_jacobi=bj, amg=amg)

    # ---- nonsymmetric convection-diffusion: ILU(0) --------------------
    C = poisson2d(n, pe=30.0)
    _, g0 = krylov.gmres(C, b, tol=1e-8, maxiter=400, backend="while_loop")
    Milu = krylov.ILUPreconditioner.from_scipy(C)
    _, g1 = krylov.gmres(C, b, tol=1e-8, Ml=Milu, backend="while_loop", maxiter=200)
    _, b1 = krylov.bicgstab(C, b, tol=1e-8, Ml=Milu, backend="while_loop", maxiter=200)
    print(f"convection-diffusion  GMRES plain: {g0.numsteps}, GMRES+ILU(0): {g1.numsteps}, "
          f"BiCGSTAB+ILU(0): {b1.numsteps}")
    out.update(gmres=g0, gmres_ilu=g1, bicgstab_ilu=b1)

    # ---- sharded: the same matrices over the ranks' row slabs ---------
    if world > 1:
        mesh = parallel.make_mesh()
        part_amg = parallel.partition_amg(A, world)
        _, samg = parallel.sharded_solve(krylov.cg, A, b, mesh=mesh, tol=1e-8,
                                         M_partition=part_amg)
        part_ilu = parallel.partition_ilu0(C, world)
        _, silu = parallel.sharded_solve(krylov.bicgstab, C, b, mesh=mesh, tol=1e-8,
                                         M_partition=part_ilu, maxiter=200)
        print(f"sharded ({world} ranks)  CG+distributed-AMG: {samg.numsteps}, "
              f"BiCGSTAB+ILU-Schwarz: {silu.numsteps}")
        out.update(sharded_amg=samg, sharded_ilu=silu)
    else:
        print("(sharded section skipped: no process group of two or more ranks; run "
              "under torchrun)")
    return out


if __name__ == "__main__":
    main()
