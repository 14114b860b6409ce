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
* :func:`sharded_solve` / :func:`make_sharded_solver`: any solver, run
  sharded,
* :mod:`multihost`: the process group from ``torchrun``'s environment.

The host-built preconditioner partitions of the reference
(``partition_amg``, ``partition_ilu0``, ``partition_block_jacobi``) are
not ported yet.
"""

from . import multihost
from .banded import ShardedBandedOperator
from .bsr import ShardedBSROperator
from .csr import ShardedCSROperator, partition_csr
from .grid import ShardedConstStencilOperator, ShardedGridStencilOperator
from .mesh import RHS, ROWS, make_mesh, psum_inner
from .pet import PETPartition, ShardedPETOperator, partition_pet
from .solve import make_sharded_solver, sharded_solve

__all__ = [
    "make_mesh",
    "psum_inner",
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
