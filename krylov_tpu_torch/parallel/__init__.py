"""Distribution layer: row-partitioned solves over ``torch.distributed``.

Counterpart of ``krylov_tpu.parallel`` (one process a device, every rank
solving its own row slab):

* :func:`make_mesh` / :func:`psum_inner`: the ``(rows, rhs)`` mesh of ranks
  and the ``all_reduce`` inner product,
* :class:`ShardedBandedOperator`, :class:`ShardedGridStencilOperator`,
  :class:`ShardedConstStencilOperator`: stencil row slabs with halo
  exchange,
* :class:`ShardedCSROperator` / :func:`partition_csr`: general sparsity
  with a halo or all-gather strategy, :class:`ShardedBSROperator`, and
  :class:`ShardedPETOperator` / :func:`partition_pet` on the CSR kernels,
* the host-built preconditioner partitions for ``sharded_solve(M_partition=)``:
  :func:`partition_amg` (distributed AMG), :func:`partition_ilu0`
  (ILU(0)-Schwarz) and :func:`partition_block_jacobi`,
* :func:`sharded_solve` / :func:`make_sharded_solver`: any solver, run
  sharded; :func:`release_kept`: the built solvers' kept graphs that hold
  collectives, released ahead of their process group's teardown,
* :mod:`multihost`: the process group from ``torchrun``'s environment.

The sharded geometric multigrid is :func:`krylov_tpu_torch.multigrid_factory`,
an ``M_factory``.
"""

from . import multihost
from ..blockjacobi import BlockJacobiPartition, partition_block_jacobi
from .amg import AMGPartition, partition_amg
from .banded import ShardedBandedOperator
from .bsr import ShardedBSROperator
from .csr import ShardedCSROperator, partition_csr
from .grid import ShardedConstStencilOperator, ShardedGridStencilOperator
from .mesh import RHS, ROWS, make_mesh, psum_inner, release_kept
from .pet import PETPartition, ShardedPETOperator, partition_pet
from .schwarz import ILUSchwarzPartition, partition_ilu0
from .solve import make_sharded_solver, sharded_solve

__all__ = [
    "AMGPartition",
    "partition_amg",
    "BlockJacobiPartition",
    "partition_block_jacobi",
    "ILUSchwarzPartition",
    "partition_ilu0",
    "make_mesh",
    "psum_inner",
    "release_kept",
    "ROWS",
    "RHS",
    "ShardedBandedOperator",
    "ShardedBSROperator",
    "ShardedPETOperator",
    "PETPartition",
    "partition_pet",
    "ShardedCSROperator",
    "ShardedConstStencilOperator",
    "ShardedGridStencilOperator",
    "partition_csr",
    "make_sharded_solver",
    "sharded_solve",
    "multihost",
]
