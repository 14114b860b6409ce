"""Multilevel preconditioning three ways, on the PyTorch port: geometric
V-cycle on a constant stencil, Galerkin multigrid on a variable-coefficient
stencil, and algebraic multigrid on a raw CSR matrix.

    python examples/torch_multigrid_solve.py [--n 256] [--device cuda]

The twin of ``examples/multigrid_solve.py`` (float64: tol=1e-8 needs it).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import scipy.sparse
import torch

import krylov_tpu_torch as krylov
from krylov_tpu_torch import AMGPreconditioner, MultigridPreconditioner
from krylov_tpu_torch.ops import stencil


def INNER(u, v):
    return torch.sum(u * v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="grid side")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)
    if args.device is not None:
        krylov.set_default_device(args.device)
    n = args.n
    rng = np.random.default_rng(0)
    dev = krylov.default_device()
    b = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    out = {}

    # 1. constant-coefficient Poisson: rediscretized geometric V-cycle
    Ac = stencil.poisson_2d_const(n, n, dtype=np.float64)
    _, plain = krylov.cg(Ac, b, inner=INNER, tol=1e-8, maxiter=2000)
    M = MultigridPreconditioner(Ac)
    sol, info = krylov.cg(Ac, b, M=M, inner=INNER, tol=1e-8, maxiter=2000)
    print(f"const-stencil MG-CG: {info.numsteps} iters "
          f"(plain CG: {plain.numsteps}); {M.n_levels} levels")
    out.update(plain=plain, mg=info, mg_levels=M.n_levels)

    # 2. variable-coefficient diffusion: exact Galerkin coarse stencils
    X, Y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    a = 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    Av = stencil.diffusion_2d(a)
    Mv = MultigridPreconditioner(Av)
    _, iv = krylov.cg(Av, b, M=Mv, inner=INNER, tol=1e-8, maxiter=2000)
    print(f"Galerkin MG-CG (variable coefficients): {iv.numsteps} iters")
    out["galerkin"] = iv

    # 3. raw CSR matrix (no grid structure exposed): algebraic multigrid
    T = scipy.sparse.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    Asp = (scipy.sparse.kron(scipy.sparse.eye(n), T)
           + scipy.sparse.kron(T, scipy.sparse.eye(n))).tocsr()
    Ma = AMGPreconditioner.from_scipy(Asp, smoother="chebyshev")
    _, ia = krylov.cg(Asp, b.reshape(-1), M=Ma, tol=1e-8, maxiter=2000)
    print(f"AMG-CG (CSR, chebyshev smoothing): {ia.numsteps} iters; "
          f"levels {Ma.level_sizes}")
    out.update(amg=ia, amg_levels=Ma.level_sizes)
    return out


if __name__ == "__main__":
    main()
