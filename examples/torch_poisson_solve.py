"""Solve a 2-D Poisson problem three ways on one GPU (the PyTorch port).

    python examples/torch_poisson_solve.py [--n 128] [--device cuda]

The twin of ``examples/poisson_solve.py`` on ``krylov_tpu_torch``: the
variable-coefficient grid stencil (kernel K1), the constant stencil under
fused CG (K3, K4) and restarted GMRES.  ``--device cpu`` runs the kernels'
plain PyTorch versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import torch

import krylov_tpu_torch as krylov
from krylov_tpu_torch import profiling
from krylov_tpu_torch.ops import stencil


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128, help="grid side")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.device is not None:
        krylov.set_default_device(args.device)
    nx = args.n
    rng = np.random.default_rng(0)
    out = {}

    # 1. variable-coefficient grid stencil (K1 on the GPU)
    A = stencil.poisson_2d(nx, nx, dtype=np.float32)
    b = torch.as_tensor(rng.standard_normal(nx * nx), dtype=torch.float32,
                        device=A.device)
    (sol, info), secs = profiling.timed_solve(
        krylov.cg, A, b, M=krylov.jacobi_preconditioner(A), tol=1e-4, maxiter=1500,
        backend="while_loop",
    )
    print(f"grid CG:   {info.numsteps} iters, {secs*1e3:.1f} ms, "
          f"final resnorm {float(info.resnorms[-1]):.3e}")
    out["grid_cg"] = info

    # 2. constant-coefficient stencil with the fused-CG driver
    Ac = stencil.poisson_2d_const(nx, nx, dtype=np.float32)
    (sol, info), secs = profiling.timed_solve(
        krylov.cg_stencil, Ac, b, tol=1e-4, maxiter=1500, fused=True
    )
    print(f"fused CG:  {info.numsteps} iters, {secs*1e3:.1f} ms")
    out["fused_cg"] = info

    # 3. restarted GMRES on the same system
    (sol, info), secs = profiling.timed_solve(
        krylov.gmres, A, b, restart=100, tol=1e-4, maxiter=600, backend="while_loop",
    )
    print(f"GMRES(m):  {info.numsteps} iters, {secs*1e3:.1f} ms")
    out["gmres"] = info
    return out


if __name__ == "__main__":
    main()
