"""SPMD solver driver: any solver of the port, row-partitioned over a mesh.

Counterpart of ``krylov_tpu.parallel.solve``.  Operator apply and inner
product are the two injection points of every solver, so the *unchanged*
solver runs sharded: the operator becomes a rank's halo-exchanging slab
(:mod:`.banded`, :mod:`.grid`, :mod:`.csr`, :mod:`.bsr`, :mod:`.pet`) and the
inner product an ``all_reduce`` (:mod:`.mesh`).  The reference runs the solve
as one ``shard_map`` program; here every rank of a ``torch.distributed``
world calls :func:`sharded_solve` with the same global arguments, solves on
its own slab with the ``while_loop`` driver, and gets back the same global
iterate and :class:`~krylov_tpu_torch.Info` as every other rank.  Every
value the driver reads on the host comes from reduced inner products, so
the ranks stop together.

The route.  The reference's sharded solve is one compiled program with no
host round trip a step; a rank's ``while_loop`` here takes the driver's
graph route as a single-device solve does, its ranks deciding as one
(:func:`krylov_tpu_torch._driver._sharded`, over the rows group: the rhs
shards solve on their own).  A rank alone on the rows axis launches no
collective, so it captures as one device does.  Two explicit rules keep
the host-stepped loop (counted in ``_driver.COUNTS["host_stepped"]``): a
staged mesh (gloo carrying CUDA tensors: every transfer goes through the
host), and a rows axis of several NCCL ranks unless :func:`nccl_graphs`.
A ``callback`` (a :class:`ShardMonitor`) takes the route a solve without
one takes: the graph route fires it on rank 0 of the rows axis from the
history rows it reads with the stop flag, as the reference fires it from
inside its compiled loop, and adds no collective.
A solver built by :func:`make_sharded_solver` keeps its captured graph
across its runs, as the reference's jit-once solver keeps its program
(:class:`krylov_tpu_torch._driver.Kept`; released with the solver, or,
where it holds collectives, before its mesh's rows group is torn down,
:func:`.mesh.release_kept`); its ranks keep, capture anew and replay as
one.

The ``M_partition`` protocol.  A partition (:func:`~krylov_tpu_torch.parallel.
partition_amg`, :func:`~krylov_tpu_torch.parallel.partition_ilu0`,
:func:`~krylov_tpu_torch.parallel.partition_block_jacobi`) is built on the
host from the global matrix and holds host state only (numpy and scipy
arrays), so it pickles to the ranks.  It has ``n_shards`` (the rows-axis
size it was built for), ``n_pad`` (the padded row count) and
``make_local(A_op, mesh)``, which takes this rank's slab by
``mesh.coord[ROWS]``, builds its tensors on ``mesh.device`` and returns the
rank's preconditioner, around the solve's own slab operator ``A_op`` where
it needs one.  The reference's ``device_arrays()`` / ``specs()`` pair, which
stacks the arrays for ``shard_map``, has no counterpart: ``make_local``
runs once a solve, and once for all solves of :func:`make_sharded_solver`.
"""

import inspect
import os
import weakref

import numpy as np
import torch

from .._driver import Kept, Ranks, ShardMonitor, _host_stepped, _keeping, _sharded
from .._info import Info
from .._operators import DiagonalOperator
from ..ops.bsr import BSROperator
from ..ops.cuda_spmv import invert_permutation, resolve_reorder
from ..ops.sparse import CSROperator
from ..ops.stencil import BandedOperator, ConstStencilOperator, GridStencilOperator
from .banded import ShardedBandedOperator
from .bsr import ShardedBSROperator
from .csr import ShardedCSROperator, _scipy_csr, partition_csr
from .grid import ShardedConstStencilOperator, ShardedGridStencilOperator
from .mesh import (
    RHS, ROWS, hold, make_mesh, psum_batch_inner, psum_block_inner, psum_fused_inner,
    psum_inner,
)
from .pet import PETPartition, ShardedPETOperator


def _tensor(v):
    """``v`` as a tensor on its own device (numpy arrays and lists on the
    CPU); the slabs go to the mesh's device."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def sharded_solve(
    solver,
    A,
    b,
    *,
    mesh=None,
    shard_rhs=False,
    x0=None,
    M_diag=None,
    M_factory=None,
    M_partition=None,
    tol=1e-5,
    atol=1e-15,
    maxiter=None,
    reorder=None,
    callback=None,
    **solver_kwargs,
):
    """Solve ``A x = b`` with ``solver`` row-partitioned over ``mesh``.

    Every rank of the mesh calls this with the same global arguments.

    * ``A``: a :class:`~krylov_tpu_torch.ops.stencil.BandedOperator`,
      :class:`GridStencilOperator` or :class:`ConstStencilOperator`, a
      :class:`~krylov_tpu_torch.ops.sparse.CSROperator` or scipy sparse
      matrix, a :class:`~krylov_tpu_torch.ops.bsr.BSROperator`, or a
      :class:`~krylov_tpu_torch.parallel.pet.PETPartition` from
      :func:`partition_pet` (general sparsity on K10 and K11).
    * ``solver``: any solver of the port taking ``(A, b, inner=, x0=,
      backend=)``.
    * ``mesh``: this rank's ``(rows[, rhs])`` mesh from :func:`make_mesh`
      (default: every rank on the rows axis; with no process group, a
      world of one).
    * ``shard_rhs``: also split the right-hand-side columns over the
      ``rhs`` axis (pure data parallelism).
    * ``M_diag``: the global diagonal of a Jacobi-type preconditioner
      ``M = diag(M_diag)`` (shape ``(N,)``), split with the vectors and
      passed to the solver as ``M`` (``Ml`` for solvers without ``M``).
    * ``M_factory``: a callable receiving the rank's slab operator and
      returning a preconditioner built on it, e.g. ``lambda A_l:
      ChebyshevPreconditioner(A_l, (lo, hi), degree=6)``: its matvecs are
      the slab's halo-exchanging ones.
    * ``M_partition``: a host-built distributed preconditioner partition
      (:func:`partition_amg`, :func:`partition_ilu0`,
      :func:`partition_block_jacobi`; the protocol above), built on the SAME
      matrix and ordering as ``A`` for ``mesh``'s rows axis; exclusive of
      ``M_diag``, ``M_factory`` and ``reorder``.  Grid operators take
      ``M_factory=multigrid_factory(...)`` instead.
    * ``reorder``: for scipy/CSR operators, solve on the symmetric RCM
      reordering (``"rcm"``, an index array, or ``"auto"``, which
      reorders when it at least halves the bandwidth); the vectors are
      permuted once a solve and the iterate comes back in user order.  For
      PET partitions pass ``reorder=`` to :func:`partition_pet`.
    * ``callback(k, resnorm)``: fired on rank 0 of the rows axis, with the
      iteration index and the global recurrence residual norm,
      ``numsteps + 1`` times (:class:`~krylov_tpu_torch._driver.ShardMonitor`).

    Returns ``(sol, Info)`` with the reference's semantics: ``sol is None``
    when unconverged, ``info.resnorms`` a host array of shape ``(numsteps
    + 1, *b.shape[1:])``; the iterate is global, on the mesh's device.
    """
    mesh = make_mesh() if mesh is None else mesh
    if M_partition is not None:
        _check_partition(A, mesh, M_diag, M_factory, M_partition, reorder)
    b = _tensor(b)

    if reorder is not None:
        # resolve once, permute the problem, recurse, un-permute the iterate
        if isinstance(A, PETPartition):
            raise ValueError("pass reorder= to partition_pet for PET partitions")
        if not (isinstance(A, CSROperator) or hasattr(A, "tocsr")):
            raise ValueError(
                "reorder= supports scipy/CSR operators (grid/banded "
                "operators are already bandwidth-ordered)"
            )
        spA = _scipy_csr(A)
        perm = resolve_reorder(spA, reorder, metric="bandwidth")
        if perm is not None:
            pj = torch.as_tensor(perm)

            def permuted(v):
                return None if v is None else _tensor(v)[pj.to(_tensor(v).device)]

            _, info = sharded_solve(
                solver, spA[perm][:, perm].tocsr(), permuted(b), mesh=mesh,
                shard_rhs=shard_rhs, x0=permuted(x0), M_diag=permuted(M_diag),
                M_factory=M_factory, tol=tol, atol=atol, maxiter=maxiter,
                callback=callback, **solver_kwargs,
            )
            inv = torch.as_tensor(invert_permutation(perm), device=info.xk.device)
            xk = info.xk[inv]
            info = info._replace(xk=xk)
            return (xk if info.success else None), info
        # "auto" kept the user order: fall through

    restart = solver_kwargs.pop("restart", None)
    if restart is not None:
        return _sharded_restarted(
            solver, A, b, restart=restart, mesh=mesh, shard_rhs=shard_rhs, x0=x0,
            M_diag=M_diag, M_factory=M_factory, M_partition=M_partition, tol=tol, atol=atol,
            maxiter=maxiter, callback=callback, **solver_kwargs,
        )

    if _grid_path(A, b, shard_rhs):
        return _sharded_solve_grid(
            solver, A, b, mesh=mesh, x0=x0, M_diag=M_diag, M_factory=M_factory,
            tol=tol, atol=atol, maxiter=maxiter, callback=callback, **solver_kwargs,
        )

    run = _make_general_run(
        solver, A, mesh=mesh, shard_rhs=shard_rhs, M_diag=M_diag, M_factory=M_factory,
        M_partition=M_partition, tol=tol, atol=atol, maxiter=maxiter, callback=callback,
        rhs_ndim=b.ndim, N=b.shape[0], solver_kwargs=solver_kwargs, keep=False,
    )
    return run(b, x0)


def _check_partition(A, mesh, M_diag, M_factory, M_partition, reorder=None):
    """The refusals an ``M_partition`` meets before anything is built."""
    if M_diag is not None or M_factory is not None:
        raise ValueError("M_partition is mutually exclusive with M_diag/M_factory")
    if reorder is not None:
        raise ValueError(
            "M_partition is built on a fixed row ordering; reorder= would misalign it "
            "(reorder the matrix before partition_amg)"
        )
    if isinstance(A, (GridStencilOperator, ConstStencilOperator)):
        raise TypeError(
            "grid operators precondition via M_factory=multigrid_factory(...), not "
            "M_partition"
        )
    if isinstance(A, PETPartition) and A.get("perm") is not None:
        raise ValueError(
            "M_partition needs the PET partition built without reorder= (orderings must "
            "match)"
        )
    n_rows = mesh.shape[ROWS]
    if M_partition.n_shards != n_rows:
        raise ValueError(
            f"M_partition built for {M_partition.n_shards} shards but the mesh rows axis "
            f"has {n_rows} ranks"
        )


def _grid_path(A, b, shard_rhs):
    """Grid operators keep the 2-D layout end to end for flat, grid-shaped
    and blocked right-hand sides (a trailing column axis rides along)."""
    if not isinstance(A, (GridStencilOperator, ConstStencilOperator)) or shard_rhs:
        return False
    grid = tuple(A.grid)
    shape = tuple(b.shape)
    return (b.ndim == 1 or shape == grid
            or (b.ndim == 2 and shape[0] == grid[0] * grid[1])
            or (b.ndim == 3 and shape[:2] == grid))


def _solver_kwargs(solver, mesh, solver_kwargs, callback, vector_ndim):
    """The solver's keywords with the mesh's reductions injected where it
    takes them, and the name of its preconditioner slot."""
    params = inspect.signature(solver).parameters
    kw = dict(solver_kwargs)
    if callback is not None:
        kw["callback"] = ShardMonitor(callback, group=mesh.group(ROWS))
    if "fused_inner" in params and "fused_inner" not in kw:
        # pipelined solvers: all of an iteration's scalars in ONE all_reduce
        kw["fused_inner"] = psum_fused_inner(mesh, ROWS, vector_ndim=vector_ndim)
    if "block_inner" in params and "block_inner" not in kw:
        # block solvers: (k, k) Gram contractions, one all_reduce each
        kw["block_inner"] = psum_block_inner(mesh, ROWS)
    if "batch_inner" in params and "batch_inner" not in kw:
        # CGS orthogonalization: the whole sweep in one all_reduce
        kw["batch_inner"] = psum_batch_inner(mesh, ROWS, vector_ndim=vector_ndim)
    # solvers without an SPD `M` slot (bicgstab, qmr) take a left one
    prec = "M" if "M" in params else ("Ml" if "Ml" in params else None)
    return kw, prec


def _preconditioner(kw, prec, solver, M_diag_l, M_factory, A_op, M_partition=None, mesh=None):
    if M_diag_l is None and M_factory is None and M_partition is None:
        return
    if prec is None:
        raise ValueError(f"{solver} accepts neither M nor Ml")
    if M_diag_l is not None:
        kw[prec] = DiagonalOperator(M_diag_l)
    elif M_factory is not None:
        kw[prec] = M_factory(A_op)
    else:
        kw[prec] = M_partition.make_local(A_op, mesh)


def _finish(mesh, xk, info, rhs_split):
    """The global success, step count and history of a rank's solve: with
    split columns each rhs shard stops on its own, so the step count is the
    largest and each shard's history is padded with zeros to it (the
    reference's preallocated history buffer)."""
    numsteps, success = int(info.numsteps), bool(info.success)
    hist = np.asarray(info.resnorms)
    if not rhs_split:
        return xk, success, numsteps, hist
    flags = torch.tensor([numsteps, int(not success)], device=mesh.device)
    flags = mesh.all_reduce(flags, RHS, op=torch.distributed.ReduceOp.MAX)
    numsteps, success = int(flags[0]), int(flags[1]) == 0
    pad = np.zeros((numsteps + 1 - hist.shape[0],) + hist.shape[1:], hist.dtype)
    hist = torch.as_tensor(np.concatenate([hist, pad]), device=mesh.device)
    hist = _gather_cols(mesh, hist).cpu().numpy()
    return _gather_cols(mesh, xk), success, numsteps, hist


def _gather_cols(mesh, t):
    """The rhs shards' columns (axis 1) side by side."""
    return mesh.all_gather_rows(t.movedim(1, 0).contiguous(), RHS).movedim(0, 1)


# Several NCCL ranks on the graph route.  On four H100s with
# NCCL_GRAPH_MIXING_SUPPORT=0 one run of tools/torch_nccl_graphs_check.sh held
# every case of tools/torch_multigpu_check.py (a ShardMonitor's too) with the
# built solvers alive at the teardown, and cg, cg_pipelined and cg_block past
# their periodic replacement bit-equal on both routes (PERF.md).  Nested
# inside a step's IF node, after the step's own collectives, a replacement
# crashed every rank: it sits beside the node (_graphs.sibling).  NCCL's
# teardown waits for every graph holding captured collectives: built
# solvers' kept graphs are released before their group goes
# (.mesh.release_kept).
def nccl_graphs():
    """Whether the ranks of a rows axis of several NCCL ranks take the graph
    route, their collectives captured into the graph's conditional bodies
    with the kernels: only where NCCL records captured work without the
    event nodes of its support for mixing graph and eager launches, which
    a conditional body refuses (``NCCL_GRAPH_MIXING_SUPPORT=0`` in the
    environment, the route's one switch;
    ``tools/torch_collective_graph_probe.py``).  NCCL then asks that no
    eager collective follow a graph launch still running: the driver reads
    the stop flag, which waits for the replays, before its next one.  Gloo
    ranks on the CPU take the route's plain twin (the tests); a rank alone
    launches no collective and captures as one device does."""
    return os.environ.get("NCCL_GRAPH_MIXING_SUPPORT") == "0"


def _graph_ranks(mesh):
    """The context of a rank's solve: its ``while_loop`` takes the graph
    route's decisions as one with the other ranks of its rows group (the
    rhs shards solve on their own and may stop at different steps).  A
    staged mesh runs the host-stepped loop, and so does a rows group of
    several NCCL ranks unless :func:`nccl_graphs`."""
    if mesh.staged or (mesh.device.type == "cuda" and not mesh.alone(ROWS)
                       and not nccl_graphs()):
        return _host_stepped()
    return _sharded(Ranks(mesh.group(ROWS), tuple(mesh._ranks[ROWS]), mesh.coord[ROWS],
                          mesh.device))


def _general_operator(A, mesh, N):
    """This rank's slab of ``A`` on its device, for flat vectors of ``N``
    rows: ``(A_op, pad_rows, rows)``, the rows the vectors are padded by
    and the slice of the padded rows the rank owns.

    Any N: structured formats pad with unit-diagonal rows or identity
    blocks, which never couple to real rows (padded vector entries stay
    exactly zero, trajectories equal the unpadded problem's)."""
    n_rows = mesh.shape[ROWS]
    i = mesh.coord[ROWS]
    dev = mesh.device
    pad_rows = (-N) % n_rows
    if isinstance(A, BSROperator):
        R, C = A.blocksize
        pad_blk = (-A.cols.shape[0]) % n_rows
        pad_rows = pad_blk * R  # vectors pad in whole blocks
        if pad_blk:
            if R != C:
                raise ValueError(
                    f"BSR identity padding needs square blocks; got {(R, C)}: choose "
                    f"a mesh whose rows axis divides {A.cols.shape[0]} block rows"
                )
            A = _pad_bsr(A, pad_blk)
    elif pad_rows and isinstance(A, BandedOperator):
        # grid stencils off the grid path too: the flat banded route, padded
        A = _pad_banded(A, pad_rows)
    n_local = (N + pad_rows) // n_rows
    rows = slice(i * n_local, (i + 1) * n_local)

    if isinstance(A, BandedOperator):
        A_op = ShardedBandedOperator(A.coeffs[:, rows].contiguous().to(dev), A.offsets, mesh,
                                     hermitian=A.hermitian)
    elif isinstance(A, PETPartition):
        if len(A["rows"]) != n_rows:
            raise ValueError(
                f"PET partition built for {len(A['rows'])} shards but the mesh "
                f"rows axis has {n_rows} ranks"
            )
        A_op = ShardedPETOperator(A["rows"][i], A["t_rows"][i], A["shape"][0], mesh,
                                  data_dtype=A["data_dtype"])
    elif isinstance(A, BSROperator):
        nb_local, max_blocks = A.cols.shape[0] // n_rows, A.cols.shape[1]
        A_op = ShardedBSROperator(
            A.data[i * nb_local * max_blocks : (i + 1) * nb_local * max_blocks].to(dev),
            A.cols[i * nb_local : (i + 1) * nb_local].to(dev), A.shape[1], mesh,
        )
    elif isinstance(A, CSROperator) or hasattr(A, "tocsr"):
        part = partition_csr(A, n_rows)

        def shard(a):
            return torch.from_numpy(np.ascontiguousarray(a[i])).to(dev)

        A_op = ShardedCSROperator(shard(part["data"]), shard(part["col"]), shard(part["row"]),
                                  part["n_local"], part["halo"], part["mode"], mesh)
    else:
        raise TypeError(f"cannot shard operator of type {type(A)}")
    return A_op, pad_rows, rows


def _kept_runs(run, roots, keep, mesh):
    """``run`` wrapped so that its solves keep their graph in one
    :class:`~krylov_tpu_torch._driver.Kept` slot (``keep``), released when
    the wrapper is collected or, once it holds collectives
    (:func:`_holds_collectives`), before ``mesh``'s rows group is torn
    down (:func:`.mesh.hold`); ``run`` itself for a one-shot solve."""
    if not keep:
        return run
    slot = Kept(roots)

    def kept_run(b, x0=None):
        with _keeping(slot):
            out = run(b, x0)
        if _holds_collectives(slot, mesh):
            hold(slot, mesh)
        return out

    kept_run.__doc__ = run.__doc__
    weakref.finalize(kept_run, slot.release)
    return kept_run


def _holds_collectives(slot, mesh):
    """Whether ``slot``'s kept graph holds collectives of ``mesh``'s rows
    group: one captured on the card by a rank not alone there (several
    NCCL ranks with :func:`nccl_graphs`; every other card mesh of several
    ranks runs host-stepped, and the CPU's plain twin captures nothing)."""
    return slot.loop is not None and mesh.device.type == "cuda" and not mesh.alone(ROWS)


def _make_general_run(
    solver, A, *, mesh, shard_rhs, M_diag, M_factory, M_partition, tol, atol, maxiter,
    callback, rhs_ndim, N, solver_kwargs, keep=True,
):
    """Build the reusable core of the general (flat-vector) sharded solve.

    Everything independent of the right-hand side's values happens here,
    once: padding and partitioning of the operator, the transfer of this
    rank's slab and preconditioner to its device, the mesh's inner
    product.  The returned ``run(b, x0=None)`` only permutes, pads and
    splits the vectors and solves; with ``keep`` its solves keep their
    captured graph from run to run.
    """
    dev = mesh.device
    maxiter = N if maxiter is None else maxiter
    # PET partitions built with reorder= hold A[perm][:, perm]: solve in that
    # order (vectors permuted once a call, the iterate un-permuted on return)
    perm = A.get("perm") if isinstance(A, PETPartition) else None
    if perm is not None and M_diag is not None:
        M_diag = _tensor(M_diag)[torch.as_tensor(perm)]
    A_op, pad_rows, rows = _general_operator(A, mesh, N)
    if M_partition is not None and M_partition.n_pad != N + pad_rows:
        raise ValueError(
            f"M_partition built for padded size {M_partition.n_pad} but the solve's padded "
            f"size is {N + pad_rows}: build the partition on the same matrix"
        )

    M_diag_l = None
    if M_diag is not None:
        Md = _tensor(M_diag)
        Md = torch.cat([Md, torch.ones(pad_rows, dtype=Md.dtype, device=Md.device)])
        M_diag_l = Md[rows].to(dev)
    kw, prec = _solver_kwargs(solver, mesh, solver_kwargs, callback, vector_ndim=1)
    _preconditioner(kw, prec, solver, M_diag_l, M_factory, A_op, M_partition, mesh)
    n_rhs = mesh.shape[RHS]
    rhs_split = shard_rhs and rhs_ndim > 1 and n_rhs > 1
    pj = None if perm is None else torch.as_tensor(perm)
    inv = None if perm is None else torch.as_tensor(invert_permutation(perm))
    inner = psum_inner((rows.stop - rows.start,), mesh)

    def run(b, x0=None):
        b = _tensor(b)
        if b.ndim != rhs_ndim or b.shape[0] != N:
            raise ValueError(
                f"this sharded solver was built for RHS of ndim {rhs_ndim} with "
                f"{N} rows; got shape {tuple(b.shape)}"
            )
        x0 = torch.zeros_like(b) if x0 is None else _tensor(x0)
        if pj is not None:
            b, x0 = b[pj.to(b.device)], x0[pj.to(x0.device)]
        cols = slice(None)
        if rhs_split:
            if b.shape[1] % n_rhs:
                raise ValueError(f"{b.shape[1]} columns do not split over {n_rhs} rhs shards")
            k_local = b.shape[1] // n_rhs
            cols = slice(mesh.coord[RHS] * k_local, (mesh.coord[RHS] + 1) * k_local)

        def slab(v):
            if pad_rows:
                v = torch.cat([v, v.new_zeros((pad_rows,) + tuple(v.shape[1:]))])
            return v[rows][:, cols].contiguous().to(dev) if v.ndim > 1 else v[rows].to(dev)

        b_l = slab(b)
        with _graph_ranks(mesh):
            _, info = solver(A_op, b_l, inner=inner, x0=slab(x0), tol=tol, atol=atol,
                             maxiter=maxiter, backend="while_loop", **kw)
        xk = mesh.all_gather_rows(info.xk, ROWS)
        xk, success, numsteps, hist = _finish(mesh, xk, info, rhs_split)
        xk = xk[:N]
        if inv is not None:
            xk = xk[inv.to(xk.device)]
        info = Info(success, xk, numsteps, hist, None, None)
        return (xk if success else None), info

    return _kept_runs(run, (A_op, kw, inner), keep, mesh)


def make_sharded_solver(
    solver,
    A,
    *,
    mesh=None,
    shard_rhs=False,
    M_diag=None,
    M_factory=None,
    M_partition=None,
    tol=1e-5,
    atol=1e-15,
    maxiter=None,
    callback=None,
    n_rhs=None,
    **solver_kwargs,
):
    """Build once, solve many: the reusable form of :func:`sharded_solve`.

    Returns ``run(b, x0=None) -> (sol, Info)`` with the trajectories of
    ``sharded_solve`` called with the same arguments.  Partitioning and
    padding of the operator and the transfer of this rank's slab and
    preconditioner happen here, once; each ``run`` only splits the vectors
    and solves.  On the graph route the solver keeps the graph its first
    capturing run captured, with its buffers, and each later run replays
    it from step 0 (the reference compiles its program once); the graph
    and its memory pool are released when ``run`` is collected, or, where
    the graph holds collectives of several NCCL ranks, before their
    process group is destroyed (:func:`.mesh.release_kept`: a script that
    bound ``destroy_process_group`` before importing this package calls
    ``parallel.release_kept()`` before it).

    * ``n_rhs``: the blocked column count the solver is built for (None: a
      single right-hand side).  Grid operators take flat ``(N,)`` or grid
      ``(M, ny)`` vectors when ``n_rhs is None``, flat ``(N, k)`` or grid
      ``(M, ny, k)`` when ``n_rhs=k``; other operators ``(N,)`` or ``(N,
      k)``.
    * ``reorder=``/``restart=`` are not taken here: pre-permute the matrix
      (or build :func:`partition_pet` with ``reorder=``) and use
      :func:`sharded_solve` for restarted cycles.
    """
    if "reorder" in solver_kwargs or "restart" in solver_kwargs:
        raise ValueError(
            "make_sharded_solver does not take reorder=/restart=: pre-permute the "
            "matrix (or partition_pet(reorder=...)) and use sharded_solve for "
            "restarted cycles"
        )
    mesh = make_mesh() if mesh is None else mesh
    if M_partition is not None:
        _check_partition(A, mesh, M_diag, M_factory, M_partition)
    if isinstance(A, (GridStencilOperator, ConstStencilOperator)) and not shard_rhs:
        return _make_grid_run(
            solver, A, mesh=mesh, tol=tol, atol=atol, maxiter=maxiter, M_diag=M_diag,
            M_factory=M_factory, callback=callback, n_rhs=n_rhs,
            solver_kwargs=solver_kwargs,
        )
    N = A["shape"][0] if isinstance(A, PETPartition) else A.shape[0]
    return _make_general_run(
        solver, A, mesh=mesh, shard_rhs=shard_rhs, M_diag=M_diag, M_factory=M_factory,
        M_partition=M_partition, tol=tol, atol=atol, maxiter=maxiter, callback=callback,
        rhs_ndim=1 if n_rhs is None else 2, N=N, solver_kwargs=solver_kwargs,
    )


def _sharded_solve_grid(solver, A, b, *, mesh, x0, tol, atol, maxiter, M_diag=None,
                        M_factory=None, callback=None, **solver_kwargs):
    """Row-partitioned solve in the grid ``(M, ny[, k])`` layout (see
    :mod:`.grid`); a trailing column axis rides along unsplit."""
    n_rhs = (
        b.shape[2] if b.ndim == 3
        else (b.shape[1] if b.ndim == 2 and tuple(b.shape) != tuple(A.grid) else None)
    )
    run = _make_grid_run(
        solver, A, mesh=mesh, tol=tol, atol=atol, maxiter=maxiter, M_diag=M_diag,
        M_factory=M_factory, callback=callback, n_rhs=n_rhs, solver_kwargs=solver_kwargs,
        keep=False,
    )
    return run(b, x0)


def _grid_slab(A, r0, r1):
    """Rows ``[r0, r1)`` of the grid coefficients, past the grid padded with
    rows whose only coefficient is a unit centre (identity maps the zero
    padded entries to zero, and diagonal-dividing solvers and smoothers
    divide by 1 there instead of 0/0)."""
    c = A.coeffs2d
    Mg = c.shape[1]
    real = c[:, min(r0, Mg) : min(r1, Mg)]
    n_pad = r1 - max(r0, Mg)
    if n_pad <= 0:
        return real.contiguous()
    cpad = c.new_zeros((c.shape[0], n_pad, c.shape[2]))
    centre = [d for d, rc in enumerate(zip(A.row_offsets, A.col_offsets)) if rc == (0, 0)]
    if centre:
        cpad[centre[0]] = 1
    return torch.cat([real, cpad], dim=1)


def _grid_operator(A, mesh):
    """This rank's grid-row slab of a grid operator on its device:
    ``(A_op, pad_grid, rows)``, the grid rows the vectors are padded by and
    the slice of padded grid rows the rank owns.

    Grid rows pad to the shard multiple: the variable-coefficient operator
    with unit-centre rows (:func:`_grid_slab`), the const stencil by
    masking rows >= Mg in its matvec; real rows next to the padding read
    zeros there, the operators' zero Dirichlet boundary, so trajectories
    are unchanged."""
    Mg, ny = A.grid
    pad_grid = (-Mg) % mesh.shape[ROWS]
    m_local = (Mg + pad_grid) // mesh.shape[ROWS]
    r0 = mesh.coord[ROWS] * m_local
    if isinstance(A, ConstStencilOperator):
        A_op = ShardedConstStencilOperator(A, m_local, mesh, m_valid=Mg if pad_grid else None)
    else:
        A_op = ShardedGridStencilOperator(
            _grid_slab(A, r0, r0 + m_local).to(mesh.device), None, ny, mesh,
            hermitian=A.hermitian, row_col_offsets=(A.row_offsets, A.col_offsets),
        )
    return A_op, pad_grid, slice(r0, r0 + m_local)


def _make_grid_run(solver, A, *, mesh, tol, atol, maxiter, M_diag, M_factory, callback,
                   n_rhs, solver_kwargs, keep=True):
    """Build-once core of the grid-layout sharded solve (see
    :func:`_make_general_run`).  ``n_rhs`` fixes the blocked column count
    (None: a single right-hand side)."""
    dev = mesh.device
    Mg, ny = A.grid
    N = Mg * ny
    maxiter = N if maxiter is None else maxiter
    grid_shape = (Mg, ny) if n_rhs is None else (Mg, ny, n_rhs)
    flat_shape = (N,) if n_rhs is None else (N, n_rhs)
    A_op, pad_grid, rows = _grid_operator(A, mesh)
    M_diag_l = None
    if M_diag is not None:
        Md = _tensor(M_diag).reshape(Mg, ny)
        Md = torch.cat([Md, torch.ones((pad_grid, ny), dtype=Md.dtype, device=Md.device)])
        M_diag_l = Md[rows].to(dev)
    kw, prec = _solver_kwargs(solver, mesh, solver_kwargs, callback, vector_ndim=2)
    _preconditioner(kw, prec, solver, M_diag_l, M_factory, A_op)

    def inner(u, v):
        # the full grid contraction; per column for a blocked RHS
        return mesh.all_reduce(torch.sum(u.conj() * v, dim=(0, 1)), ROWS)

    def run(b, x0=None):
        b = _tensor(b)
        if tuple(b.shape) not in (flat_shape, grid_shape):
            raise ValueError(
                f"this sharded solver was built for RHS shape {flat_shape} or "
                f"{grid_shape}; got {tuple(b.shape)}"
            )
        flat_in = tuple(b.shape) == flat_shape

        def slab(v):
            v = v.reshape(grid_shape)
            if pad_grid:
                v = torch.cat([v, v.new_zeros((pad_grid,) + grid_shape[1:])])
            return v[rows].contiguous().to(dev)

        b_l = slab(b)
        x0_l = torch.zeros_like(b_l) if x0 is None else slab(_tensor(x0))
        with _graph_ranks(mesh):
            _, info = solver(A_op, b_l, inner=inner, x0=x0_l, tol=tol, atol=atol,
                             maxiter=maxiter, backend="while_loop", **kw)
        xk = mesh.all_gather_rows(info.xk, ROWS)[:Mg]
        if flat_in:
            xk = xk.reshape(b.shape)
        info = Info(bool(info.success), xk, int(info.numsteps), np.asarray(info.resnorms),
                    None, None)
        return (xk if info.success else None), info

    return _kept_runs(run, (A_op, kw, inner), keep, mesh)


def _pad_banded(A, pad):
    """``A`` with ``pad`` unit-diagonal rows appended.

    Real rows' coefficients into the padded columns were already zero (the
    banded contract), and padded rows carry only the unit diagonal, so
    padded entries of every solver vector stay exactly zero (the banded
    twin of :func:`~krylov_tpu_torch.parallel.csr.pad_unit_diagonal`)."""
    coeffs = A.coeffs
    ndiag, N0 = coeffs.shape
    coeffs2 = torch.cat([coeffs, coeffs.new_zeros((ndiag, pad))], dim=1)
    offsets = tuple(A.offsets)
    if 0 in offsets:
        coeffs2[offsets.index(0), N0:] = 1
    else:
        diag = torch.cat([coeffs.new_zeros((1, N0)), coeffs.new_ones((1, pad))], dim=1)
        coeffs2 = torch.cat([coeffs2, diag], dim=0)
        offsets = offsets + (0,)
    return BandedOperator(coeffs2, offsets, hermitian=A.hermitian)


def _pad_bsr(A, pad_blk):
    """``A`` with ``pad_blk`` identity-block rows appended (square blocks);
    the zero-coupling contract of :func:`_pad_banded`."""
    nbrows, max_blocks = A.cols.shape
    R, _ = A.blocksize
    dpad = A.data.new_zeros((pad_blk * max_blocks, R, R))
    dpad[::max_blocks] = torch.eye(R, dtype=A.data.dtype, device=A.data.device)
    cpad = A.cols.new_zeros((pad_blk, max_blocks))
    cpad[:, 0] = nbrows + torch.arange(pad_blk, dtype=A.cols.dtype, device=A.cols.device)
    return BSROperator(
        torch.cat([A.data, dpad]), torch.cat([A.cols, cpad]),
        (A.shape[0] + pad_blk * R, A.shape[1] + pad_blk * R),
    )


def _sharded_restarted(solver, A, b, *, restart, mesh, shard_rhs, x0, M_diag,
                       M_factory=None, M_partition=None, tol, atol, maxiter, callback=None,
                       **solver_kwargs):
    """Restarted sharded solve: one sharded solve a cycle, warm-started.

    Convergence is judged against the initial residual's criterion across
    cycles (the contract of the single-device ``gmres(restart=m)``).  A
    ``callback`` fires per cycle with cycle-local iteration indices."""
    N = b.shape[0] if b.ndim == 1 else int(np.prod(tuple(b.shape)))
    total_max = N if maxiter is None else maxiter
    m = min(restart, total_max)

    x = x0
    resnorms = None
    criterion = None
    numsteps = 0
    success = False
    while True:
        kw = dict(
            mesh=mesh, shard_rhs=shard_rhs, x0=x, M_diag=M_diag, M_factory=M_factory,
            M_partition=M_partition, maxiter=min(m, total_max - numsteps), callback=callback,
            **solver_kwargs,
        )
        if criterion is None:
            _, info = sharded_solve(solver, A, b, tol=tol, atol=atol, **kw)
            # per-column criterion, as a single cycle's
            criterion = np.maximum(tol * np.asarray(info.resnorms[0]), atol)
            resnorms = np.asarray(info.resnorms)
        else:
            _, info = sharded_solve(solver, A, b, tol=0.0, atol=criterion, **kw)
            resnorms = np.concatenate([resnorms, np.asarray(info.resnorms)[1:]])
        numsteps += info.numsteps
        x = info.xk
        success = bool(info.success)
        if success or numsteps >= total_max or info.numsteps == 0:
            break

    info = Info(success, x, numsteps, resnorms, None, None)
    return (x if success else None), info
