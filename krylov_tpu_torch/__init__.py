"""krylov_tpu_torch — the PyTorch and CUDA port of krylov_tpu.

Same solver contract as ``krylov_tpu`` (the reference package, which this
package never imports): every solver is a functional recurrence driven by
one loop in two backends, ``eager`` (host loop, the float64 parity mode on
CPU) and ``while_loop`` (state and residual history resident on the
device, one stop-flag read per step).  The kernels are hand-written CUDA
for Hopper (``krylov_tpu_torch/csrc``), built with ``nvcc`` at first use; on
CPU tensors the same entry points run the kernels' plain PyTorch versions.

Every entry point runs on the CUDA device unless the caller asks for the
CPU: a tensor argument keeps its own device, and inputs that carry none
(numpy arrays, lists, scipy matrices) go to the operator's device or to the
default device, the current CUDA device.  ``set_default_device("cpu")`` asks
for the CPU; without a CUDA device and without that call the first such
input raises.

Ported so far: compiled CG on grid stencils (:func:`cg`, :func:`cg_stencil`,
the banded and grid-stencil operators, the L0 operator and driver layer),
the constant-coefficient stencil operator, fused CG on both stencil
operators (unpreconditioned and Jacobi-preconditioned), the geometric
multigrid preconditioner (:class:`MultigridPreconditioner`), general
sparsity: scipy matrices through :func:`as_operator` (CSR, BSR and the CSR
kernels) and the Arnoldi processes, and the Krylov solver family:
:func:`bicgstab`, :func:`gmres`, :func:`fgmres`, the two-sided :func:`qmr`
and :func:`bicg`, :func:`cgs`, :func:`tfqmr`, :func:`minres`,
:func:`symmlq`, :func:`cgr`, :func:`gcr`, :func:`chebyshev`, the
normal-equation solvers :func:`cgne`, :func:`cgnr` and :func:`lsqr`,
:func:`cg_pipelined`, :func:`cg_block` and mixed-precision :func:`refine`,
the stationary methods :func:`richardson`, :func:`jacobi`,
:func:`gauss_seidel`, :func:`sor` and :func:`ssor` with
:class:`SSORSmoother` (grid, level-scheduled and dense triangular sweeps),
the analysis utilities (:mod:`krylov_tpu_torch.utils`) and the
preconditioners on general sparsity: :class:`ChebyshevPreconditioner`,
:class:`BlockJacobiPreconditioner`, :class:`ILUPreconditioner` and the
smoothed-aggregation :class:`AMGPreconditioner` (their host set-up in numpy
and in the native helpers of :mod:`krylov_tpu_torch.ops._native`),
differentiable solves (:mod:`krylov_tpu_torch.diffable`, gradients by the
implicit function theorem through one adjoint solve) and
:mod:`krylov_tpu_torch.profiling` (traces, timed solves, byte models and
roofline shares), and the distribution layer :mod:`krylov_tpu_torch.parallel`
(row-partitioned solves over ``torch.distributed``: the mesh, the sharded
operators, :func:`~krylov_tpu_torch.parallel.sharded_solve` and its
host-built preconditioner partitions: distributed AMG, ILU(0)-Schwarz and
block Jacobi) with the sharded geometric multigrid
(:class:`ShardedMultigridPreconditioner`, :func:`multigrid_factory`).
With them the port does all that ``krylov_tpu`` does.
"""

from . import convert, diffable, ops, parallel, profiling, utils
from .__about__ import __version__
from ._device import default_device, set_default_device
from ._info import Info
from ._operators import (
    ChebyshevPreconditioner,
    DiagonalOperator,
    Identity,
    MatrixOperator,
    Product,
    as_operator,
    jacobi_preconditioner,
)
from .amg import AMGPreconditioner
from .arnoldi import (
    ArnoldiCGS,
    ArnoldiHouseholder,
    ArnoldiLanczos,
    ArnoldiMGS,
    arnoldi_res,
)
from .blockjacobi import BlockJacobiPreconditioner
from .errors import ArgumentError
from .givens import givens
from .householder import Householder
from .ilu import ILUPreconditioner
from .multigrid import MultigridPreconditioner, ShardedMultigridPreconditioner, multigrid_factory
from .ops.stencil import poisson_2d_const, poisson_3d_const
from .solvers import (
    SSORSmoother,
    bicg,
    bicgstab,
    cg,
    cg_block,
    cg_pipelined,
    cg_stencil,
    cgne,
    cgnr,
    cgr,
    cgs,
    chebyshev,
    fgmres,
    gauss_seidel,
    gcr,
    gmres,
    jacobi,
    lsqr,
    minres,
    qmr,
    refine,
    richardson,
    sor,
    ssor,
    symmlq,
    tfqmr,
)

aslinearoperator = as_operator  # the reference's alias

__all__ = [
    "AMGPreconditioner",
    "ArgumentError",
    "ArnoldiCGS",
    "ArnoldiHouseholder",
    "ArnoldiLanczos",
    "ArnoldiMGS",
    "BlockJacobiPreconditioner",
    "ChebyshevPreconditioner",
    "DiagonalOperator",
    "Householder",
    "ILUPreconditioner",
    "Identity",
    "Info",
    "MatrixOperator",
    "MultigridPreconditioner",
    "Product",
    "SSORSmoother",
    "ShardedMultigridPreconditioner",
    "arnoldi_res",
    "as_operator",
    "aslinearoperator",
    "bicg",
    "bicgstab",
    "cg",
    "cg_block",
    "cg_pipelined",
    "cg_stencil",
    "cgne",
    "cgnr",
    "cgr",
    "cgs",
    "chebyshev",
    "convert",
    "default_device",
    "diffable",
    "fgmres",
    "gauss_seidel",
    "gcr",
    "givens",
    "gmres",
    "jacobi",
    "jacobi_preconditioner",
    "lsqr",
    "minres",
    "multigrid_factory",
    "ops",
    "parallel",
    "poisson_2d_const",
    "poisson_3d_const",
    "profiling",
    "qmr",
    "refine",
    "richardson",
    "sor",
    "ssor",
    "set_default_device",
    "symmlq",
    "tfqmr",
    "utils",
    "__version__",
]
