"""Multi-process initialization and process-spanning meshes.

Counterpart of ``krylov_tpu.parallel.multihost``.  A sharded solve over
several GPUs is one process a GPU; ``torchrun`` starts them and sets
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, which :func:`initialize` reads::

    from krylov_tpu_torch import parallel
    parallel.multihost.initialize()          # the process group
    mesh = parallel.multihost.global_mesh()  # every rank, (rows, rhs)
    sol, info = parallel.sharded_solve(krylov_tpu_torch.cg, A, b, mesh=mesh)

Every rank passes the same global arguments to ``sharded_solve``.
"""

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               timeout=DEFAULT_TIMEOUT):
    """Initialize the process group (a second call is a no-op).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``, as ``torchrun`` sets them.  NCCL carries CUDA tensors and
    gloo CPU tensors (gloo alone without CUDA).  With no arguments and
    none of those variables set, this is a single-process run: nothing is
    initialized, and :func:`~krylov_tpu_torch.parallel.make_mesh` starts a
    world of one.  Explicit arguments that cannot start the group raise:
    a misconfigured job fails loudly rather than run alone.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return  # a single-process environment
    if any(v is None for v in given):
        raise ValueError(
            "multihost.initialize needs the coordinator address, the number of "
            f"processes and this process's id; got {given}"
        )
    if torch.cuda.is_available():
        backend = "cpu:gloo,cuda:nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count())
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=float(timeout)),
    )


def global_mesh(n_rhs=1):
    """A ``(rows, rhs)`` mesh over every rank of the job (rank order: the
    rows axis is contiguous in ``RANK``, so ranks of one node are rows
    neighbours and the halo transfers cross nodes only at node edges)."""
    from .mesh import make_mesh

    return make_mesh(n_rhs=n_rhs)


def process_info():
    """``(process_index, process_count, local_device_count)`` for logging."""
    if not dist.is_initialized():
        return 0, 1, max(1, torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size(), max(1, torch.cuda.device_count())
