"""Run a job on every rank of a world of local processes.

The reference's sharded solve is one program over a device mesh; the port's
is one process a rank.  This module starts such a world on one machine, for
tests and checks: ``world_size`` processes (the ``spawn`` start method, a
rendezvous through a ``file://`` store in a fresh temporary directory, no
network port), each running the same job and sending back its result.

* :func:`run_spmd` starts a world, runs one job and stops it;
  :class:`SPMDPool` keeps one for many jobs (a process takes seconds to
  import torch), run one at a time (``run``), or sent off while the caller
  works (``submit``, then ``.result()``).
* A job is a function of this package (workers unpickle it by import path,
  so a worker imports nothing of the caller's module) taking numpy arrays,
  scipy matrices and the port's operators on the CPU; each rank moves its
  slab to its device.
* The caller gets rank 0's result, after a check that every rank returned
  the same ``x`` and ``info``; ``result["per_rank"]`` holds each rank's
  other fields.
* Nothing waits without a bound: a rank's exception, a rank's death or the
  job's timeout kills every rank and raises :class:`SPMDError` (or
  ``TimeoutError``) in the caller.
"""

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

_FORBIDDEN = ("jax", "jaxlib", "krylov_tpu", "triton")
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class SPMDError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def _worker(rank, world_size, store, backend, device, group_timeout, conn):
    import torch
    import torch.distributed as dist

    import krylov_tpu_torch as kt

    torch.set_num_threads(1)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    kt.set_default_device(dev)
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=group_timeout),
    )
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            job, args, kwargs = msg
            try:
                out = ("ok", job(*args, **kwargs))
            except Exception:
                out = ("error", traceback.format_exc())
            conn.send(out)
    finally:
        dist.destroy_process_group()


class SPMDPool:
    """A world of ``world_size`` local ranks kept for many jobs.

    ``backend``: ``"gloo"`` (CPU tensors, or CUDA tensors staged through
    the host) or ``"nccl"``; ``device``: ``"cpu"`` or ``"cuda"`` (rank r
    on ``cuda:r % device_count()``).  ``timeout`` (seconds) bounds each
    job, ``group_timeout`` each collective of the default group.  The
    world starts at the first job and again after a failure.
    """

    def __init__(self, world_size, backend="gloo", device="cpu", timeout=120.0,
                 group_timeout=60.0):
        self.world_size = int(world_size)
        self.backend = backend
        self.device = device
        self.timeout = float(timeout)
        self.group_timeout = float(group_timeout)
        self._procs = []
        self._conns = []
        self._dir = None
        self._job = None  # the job in flight

    def _start(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="krylov_spmd_")
        store = os.path.join(self._dir, "store")
        # one thread a rank in the host's BLAS too (torch's is set in the
        # worker): ranks that each spin a full thread pool contend for the
        # cores, and a small dense inverse of the set-up then takes seconds
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
        try:
            for rank in range(self.world_size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker, daemon=True,
                    args=(rank, self.world_size, store, self.backend, self.device,
                          self.group_timeout, child),
                )
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def close(self):
        """Stop every rank (killed if it does not stop at once)."""
        self._job = None
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for proc in self._procs:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def _kill(self):
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def submit(self, job, *args, timeout=None, **kwargs):
        """Send ``job(*args, **kwargs)`` to every rank and return at once:
        ``.result()`` on the returned :class:`SPMDJob` waits for it, so the
        caller can work while the ranks do.  One job is in flight at a
        time: submitting the next collects this one first."""
        if self._job is not None:
            self._job._collect()
        if not self._procs:
            self._start()
        for r, conn in enumerate(self._conns):
            try:
                conn.send((job, args, kwargs))
            except OSError as e:  # the rank is gone (its start failed)
                self._kill()
                raise SPMDError(f"{job.__name__}: rank {r} takes no job: {e}") from e
        self._job = SPMDJob(self, job, self.timeout if timeout is None else float(timeout))
        return self._job

    def run(self, job, *args, timeout=None, **kwargs):
        """``job(*args, **kwargs)`` on every rank; rank 0's result."""
        return self.submit(job, *args, timeout=timeout, **kwargs).result()


class SPMDJob:
    """A job in flight on an :class:`SPMDPool`'s ranks."""

    def __init__(self, pool, job, timeout):
        self._pool = pool
        self._job = job
        self._deadline = time.monotonic() + timeout
        self._result = None
        self._error = None

    def result(self):
        """Rank 0's result (see :func:`_merged`), once every rank is done;
        raises what the job raised."""
        self._collect()
        if self._error is not None:
            raise self._error
        return self._result

    def _collect(self):
        pool = self._pool
        if pool._job is not self:
            return  # collected already
        pool._job = None
        try:
            self._result = _merged(self._job, self._wait(pool))
        except (SPMDError, TimeoutError) as e:
            pool._kill()
            self._error = e

    def _wait(self, pool):
        from multiprocessing.connection import wait

        name = self._job.__name__
        results = [None] * pool.world_size
        pending = set(range(pool.world_size))
        while pending:
            remaining = self._deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{name}: ranks {sorted(pending)} gave no result within the "
                    "timeout; every rank was stopped"
                )
            waitables = {pool._conns[r]: r for r in pending}
            waitables.update({pool._procs[r].sentinel: r for r in pending})
            for ready in wait(list(waitables), timeout=remaining):
                r = waitables[ready]
                if r not in pending:
                    continue
                conn = pool._conns[r]
                if ready is not conn and not conn.poll():
                    raise SPMDError(f"{name}: rank {r} exited with code "
                                    f"{pool._procs[r].exitcode}")
                status, value = conn.recv()
                if status != "ok":
                    raise SPMDError(f"{name}: rank {r} raised\n{value}")
                results[r] = value
                pending.discard(r)
        return results


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    return a == b


def _merged(job, results):
    """Rank 0's result, once every rank's ``x`` and ``info`` match it."""
    first = results[0]
    if not isinstance(first, dict):
        return first
    for r, res in enumerate(results[1:], 1):
        for key in ("x", "info"):
            if key in first and not _same(first[key], res[key]):
                raise SPMDError(f"{job.__name__}: rank {r}'s {key} differs from rank 0's")
    out = dict(first)
    out["per_rank"] = [{k: v for k, v in res.items() if k not in ("x", "info")}
                       for res in results]
    return out


def run_spmd(job, world_size, *args, backend="gloo", device="cpu", timeout=120.0, **kwargs):
    """``job(*args, **kwargs)`` on each rank of a fresh world of
    ``world_size`` local processes; rank 0's result (see :class:`SPMDPool`)."""
    with SPMDPool(world_size, backend=backend, device=device, timeout=timeout) as pool:
        return pool.run(job, *args, **kwargs)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def _counts():
    """What this rank launched since the counters were last reset: kernel
    launches, collective launches and host-staged transfers, the
    ``while_loop`` routes its solves took, the routes of its BSR adjoint
    products, and the modules of the packages the port must never
    import."""
    from .. import _driver
    from ..ops import cuda_bsr, cuda_spmv, cuda_stencil
    from . import mesh

    launches = {**cuda_stencil.LAUNCHES, **cuda_spmv.LAUNCHES, **cuda_bsr.LAUNCHES}
    return {
        "launches": {k: v for k, v in launches.items() if v},
        "collectives": dict(mesh.COUNTS),
        "staged": dict(mesh.STAGED),
        "routes": {k: _driver.COUNTS[k] for k in ("host_stepped", "graph_route", "captures")},
        "adjoint_paths": {k: v for k, v in cuda_bsr.ADJOINT_PATHS.items() if v},
        "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN),
    }


def _reset():
    from .. import _driver
    from ..ops import cuda_bsr, cuda_spmv, cuda_stencil
    from . import mesh

    for mod in (cuda_stencil, cuda_spmv, cuda_bsr):
        mod.reset_launches()
    mesh.reset_counts()
    _driver.reset_counts()


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


def _info(info):
    return (bool(info.success), int(info.numsteps), np.asarray(info.resnorms))


def solve_job(solver, A, b, *, mesh_rows=None, mesh_rhs=1, record=False, **kwargs):
    """:func:`~krylov_tpu_torch.parallel.sharded_solve` on this rank's
    ``(mesh_rows, mesh_rhs)`` mesh.

    Returns ``x`` (``info.xk``, on the host), ``info`` (success, numsteps,
    resnorms), with ``record`` the ``(k, resnorm)`` calls of the callback
    on this rank, and :func:`_counts`."""
    from .mesh import make_mesh
    from .solve import sharded_solve

    mesh = make_mesh(mesh_rows, mesh_rhs)
    calls = []
    if record:
        kwargs["callback"] = lambda k, rn: calls.append((int(k), np.asarray(rn)))
    _reset()
    _, info = sharded_solve(solver, A, b, mesh=mesh, **kwargs)
    return {"x": _host(info.xk), "info": _info(info), "calls": calls, **_counts()}


def solver_job(solver, A, bs, *, mesh_rows=None, mesh_rhs=1, **kwargs):
    """:func:`~krylov_tpu_torch.parallel.make_sharded_solver` built once and
    run on each right-hand side of ``bs``."""
    from .mesh import make_mesh
    from .solve import make_sharded_solver

    run = make_sharded_solver(solver, A, mesh=make_mesh(mesh_rows, mesh_rhs), **kwargs)
    _reset()
    infos = [run(b)[1] for b in bs]
    return {"x": [_host(i.xk) for i in infos], "info": [_info(i) for i in infos], **_counts()}


def apply_job(A, x, *, n_rows=None, adjoint=False):
    """This rank's slab of ``A`` (the slab ``sharded_solve`` builds) applied
    to its slab of ``x`` (``rmatvec`` with ``adjoint``), gathered."""
    import torch

    from ..ops.stencil import ConstStencilOperator, GridStencilOperator
    from .mesh import ROWS, make_mesh
    from .solve import _general_operator, _grid_operator, _tensor

    mesh = make_mesh(n_rows)
    x = _tensor(x)
    n = x.shape[0]
    grid = isinstance(A, (GridStencilOperator, ConstStencilOperator))
    if grid and tuple(x.shape[:2]) == tuple(A.grid):
        A_op, pad, rows = _grid_operator(A, mesh)
    else:
        A_op, pad, rows = _general_operator(A, mesh, n)
    x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    _reset()
    x_l = x[rows].contiguous().to(mesh.device)
    y_l = A_op.rmatvec(x_l) if adjoint else A_op @ x_l
    return {"x": _host(mesh.all_gather_rows(y_l, ROWS)[:n]), **_counts()}


def collectives_job(x, y, V, U, *, n_rows=None, raise_rank=None, skip_rank=None,
                    group_timeout=60.0):
    """The mesh's transport and its four reductions on this rank's slabs of
    ``x``, ``y`` (``(N, ...)``), ``V`` (a ``(K, N, ...)`` basis) and ``U``
    (``(N, k)``).  ``raise_rank`` raises on that rank, ``skip_rank`` skips
    the first reduction there (the others wait for it until
    ``group_timeout``, in seconds)."""
    import torch

    from .mesh import (
        ROWS, make_mesh, psum_batch_inner, psum_block_inner, psum_fused_inner,
        psum_inner,
    )

    mesh = make_mesh(n_rows, timeout=group_timeout)
    i, n = mesh.coord[ROWS], mesh.shape[ROWS]
    if raise_rank == i:
        raise ValueError(f"rank {i} raises on purpose")
    x, y, V, U = (torch.as_tensor(a) for a in (x, y, V, U))
    m = x.shape[0] // n
    xs, ys, Us = (a[i * m : (i + 1) * m].to(mesh.device) for a in (x, y, U))
    Vs = V[:, i * m : (i + 1) * m].to(mesh.device)
    if skip_rank != i:
        total = mesh.all_reduce(torch.ones(3, device=mesh.device) * (i + 1))
    else:
        total = None
    out = {
        "sum": _host(total),
        "up": _host(mesh.shift(xs, +1)),
        "down": _host(mesh.shift(xs, -1)),
        "gather": _host(mesh.all_gather_rows(xs)),
        "scatter": _host(mesh.reduce_scatter_rows(
            torch.as_tensor(y).to(mesh.device) * (i + 1))),
        "inner": _host(psum_inner(xs.shape, mesh)(xs, ys)),
        "fused": [_host(t) for t in psum_fused_inner(mesh)(((xs, ys), (ys, ys)))],
        "batch": _host(psum_batch_inner(mesh)(Vs, ys)),
        "block": _host(psum_block_inner(mesh)(Us, Us)),
    }
    return {"info": (out["sum"], out["gather"], out["inner"], out["fused"], out["batch"],
                     out["block"]), **out, **_counts()}


def monitor_job(solver, A, b, *, backend, n_rows=None, **kwargs):
    """``solver`` called directly on this rank's grid slab with a
    :class:`~krylov_tpu_torch._driver.ShardMonitor` under ``backend``:
    the calls this rank's monitor made, and the solve's info."""
    import torch

    from .._driver import ShardMonitor
    from .mesh import ROWS, make_mesh
    from .solve import _grid_operator, _tensor

    mesh = make_mesh(n_rows)
    A_op, _, rows = _grid_operator(A, mesh)
    b_l = _tensor(b).reshape(A.grid)[rows].contiguous().to(mesh.device)
    calls = []
    monitor = ShardMonitor(lambda k, rn: calls.append((int(k), np.asarray(rn))),
                           group=mesh.group(ROWS))

    def inner(u, v):
        return mesh.all_reduce(torch.sum(u.conj() * v, dim=(0, 1)))

    _, info = solver(A_op, b_l, inner=inner, callback=monitor, backend=backend, **kwargs)
    return {"info": _info(info), "calls": calls}


def partition_apply_job(A, part, x, *, adjoint=False):
    """This rank's preconditioner from the partition ``part``
    (``make_local`` around the slab ``sharded_solve`` builds of ``A``)
    applied to its slab of the padded ``x`` (``rmatvec`` with ``adjoint``),
    gathered: ``x`` has the partition's padded row count."""
    from .mesh import ROWS, make_mesh
    from .solve import _general_operator, _tensor

    mesh = make_mesh()
    n = A["shape"][0] if isinstance(A, dict) else A.shape[0]
    A_op, _, rows = _general_operator(A, mesh, n)
    M = part.make_local(A_op, mesh)
    x_l = _tensor(x)[rows].contiguous().to(mesh.device)
    _reset()
    y_l = M.rmatvec(x_l) if adjoint else M @ x_l
    return {"x": _host(mesh.all_gather_rows(y_l, ROWS)), **_counts()}


def transfer_job(x, nd, scale):
    """The sharded order-2 restriction and prolongation of
    :mod:`krylov_tpu_torch.multigrid` over the leading ``nd`` axes of this
    rank's slab (along axis 0) of the grid vector ``x``, each gathered."""
    import torch

    from ..multigrid import _sharded_lin_prolong, _sharded_lin_restrict
    from .mesh import ROWS, make_mesh

    mesh = make_mesh()
    x = torch.as_tensor(x)
    m = x.shape[0] // mesh.shape[ROWS]
    x_l = x[mesh.coord[ROWS] * m : (mesh.coord[ROWS] + 1) * m].contiguous().to(mesh.device)
    restricted = _sharded_lin_restrict(x_l, nd, scale, mesh, ROWS)
    prolonged = _sharded_lin_prolong(x_l, nd, mesh, ROWS)
    return {"x": (_host(mesh.all_gather_rows(restricted, ROWS)),
                  _host(mesh.all_gather_rows(prolonged, ROWS)))}


def main_job(module, argv):
    """``module.main(argv)`` on this rank, for a script importable by name
    (an example): each ``Info`` it returns as ``(success, numsteps)``."""
    import importlib

    from .._info import Info

    out = importlib.import_module(module).main(list(argv))
    return {k: (bool(v.success), int(v.numsteps)) for k, v in out.items() if isinstance(v, Info)}


def _rule_costs(host_s, device_s=0.0):
    """Synthetic costs for the graph route's rule on this rank: a host
    step of ``host_s[rank]`` seconds, launches of 1 us, ``device_s`` of
    device time."""
    import torch.distributed as dist

    from .._driver import Costs

    mine = float(host_s[dist.get_rank() % len(host_s)])
    return lambda left: Costs(left, mine, 1e-6, float(device_s), 0.0, 0.0)


def graph_job(solver, A, b, *, route, mesh_rows=None, mesh_rhs=1, build=False,
              read_rank=None, fail_rank=None, unsplit=False, **kwargs):
    """The solve of :func:`solve_job` (with ``build``,
    :func:`~krylov_tpu_torch.parallel.make_sharded_solver` built once and
    run on each right-hand side of the list ``b``, an entry ``(b, x0)``
    with a first iterate) on this rank, first on the host-stepped loop,
    then on ``route``, the graph route's plain twin
    (:func:`krylov_tpu_torch._driver._plain_graph`):

    * ``("plain", after, steps, replays)``: that plan, forced;
    * ``("rule", host_s[, device_s])``: the cost rule's plan, decided from
      step 3 on costs fed per rank (:func:`_rule_costs`);
    * ``("capture", after, steps, replays)``: that plan forced on the
      card (:func:`krylov_tpu_torch._driver._capture_at`), a CUDA graph.

    ``read_rank``: on that rank of the rows axis each ``all_reduce`` reads
    its operand on the host.  ``fail_rank``: that rank's capture raises.
    ``unsplit``: a guarded step's conds nest in its guard (the structure
    before ``guard.sibling``), to show what the nesting record catches.
    Returns ``x`` and ``info`` as (host-stepped, route) pairs, each route's
    collectives and kernel launches, the route's driver counts and plan,
    with ``build`` each run's ``kept`` and ``unkept``
    (``_driver.LAST_GRAPH``),
    the conditional nesting of each collective the route launched (sorted
    ``(collective, nesting)`` pairs, :func:`._graphs.launch_nesting`), and
    the error the route raised (then ``x`` and ``info`` hold the
    host-stepped results only)."""
    import contextlib
    from unittest import mock

    from .. import _driver, _graphs
    from . import mesh as pm
    from .mesh import ROWS, Mesh, make_mesh
    from .solve import make_sharded_solver, sharded_solve

    mesh = make_mesh(mesh_rows, mesh_rhs)
    patches = contextlib.ExitStack()
    if unsplit:
        patches.enter_context(mock.patch.object(_graphs, "_splits", lambda: False))
    if read_rank == mesh.coord[ROWS]:
        reduce = Mesh.all_reduce

        def reading(self, t, *args, **kw):
            float(t.real.sum())  # a read of a device value on the host
            return reduce(self, t, *args, **kw)

        patches.enter_context(mock.patch.object(Mesh, "all_reduce", reading))
    out = {"x": [], "info": [], "collectives": [], "launches": [], "error": None, "kept": []}
    if build:
        solve = make_sharded_solver(solver, A, mesh=mesh, **kwargs)

        def run():
            infos = []
            for bj in b:
                infos.append(solve(*bj)[1] if isinstance(bj, tuple) else solve(bj)[1])
                out["kept"].append((_driver.LAST_GRAPH.get("kept"),
                                    _driver.LAST_GRAPH.get("unkept")))
            return [_host(i.xk) for i in infos], [_info(i) for i in infos]
    else:
        def run():
            _, info = sharded_solve(solver, A, b, mesh=mesh, **kwargs)
            return _host(info.xk), _info(info)

    def record(x, info):
        out["x"].append(x)
        out["info"].append(info)
        counts = _counts()
        out["collectives"].append(counts["collectives"])
        out["launches"].append(counts["launches"])

    with patches:
        _reset()
        with _driver._host_stepped():
            record(*run())
        if route[0] == "plain":
            ctx = _driver._plain_graph(*route[1:])
        elif route[0] == "capture":
            ctx = _driver._capture_at(*route[1:])
        else:
            ctx = _driver._plain_graph(costs=_rule_costs(*route[1:]))
            patches.enter_context(mock.patch.object(_driver, "FIRST_CHECK", 3))
        if fail_rank == mesh.coord[ROWS]:
            def failing(self, *args):
                raise RuntimeError(f"rank {fail_rank}'s capture fails on purpose")

            patches.enter_context(mock.patch.object(_driver._GraphLoop, "_capture", failing))
        _reset()
        out["kept"].clear()  # the route's runs only
        try:
            with ctx, _graphs.launch_nesting() as noted:
                record(*run())
        except RuntimeError as exc:
            out["error"] = str(exc)
        out["nesting"] = sorted({(key, path) for table, key, path in noted
                                 if table is pm.COUNTS})
    out["driver"] = dict(_driver.COUNTS)
    out["plan"] = _driver.LAST_GRAPH.get("plan")
    out["forbidden"] = _counts()["forbidden"]
    return out


def teardown_job(solver, A, b, *, route, how="destroy", **kwargs):
    """Two solvers built on this rank (:func:`~krylov_tpu_torch.parallel.
    make_sharded_solver`), each run once on ``route`` (``("plain", after,
    steps, replays)``, or ``("capture", ...)`` on the card) so that it
    keeps its graph: one over the world's rows axis, on groups made for
    this job, and one on this rank alone (``Mesh.of_one``).  The first
    one's slot is held as a card's NCCL ranks hold theirs (the CPU's plain
    twin holds no collective: the route holds nothing here).  Then its
    rows group is destroyed while both solvers are alive: through
    ``torch.distributed.destroy_process_group`` (``how="destroy"``), or
    through torch's own function after ``parallel.release_kept`` (``how=
    "bound"``, a script that bound the name before importing the package).

    Returns ``order``: each kept slot's release (``("release", which,
    whether it held a graph)``) and the group's teardown
    (``("destroy", "rows")``) in the order they came; ``held``: whether the
    route held each slot; ``kept``: for each solver what its run kept and
    whether its slot holds a graph after the teardown; ``again``: what the
    one-rank solver's next run did; ``cached``: whether the mesh's group
    cache still holds the destroyed group."""
    import inspect
    from unittest import mock

    import torch.distributed as dist

    from .. import _driver
    from . import mesh as pm
    from .mesh import ROWS, Mesh, make_mesh
    from .solve import make_sharded_solver

    # groups of this job's own (a timeout no other mesh uses), so that the
    # world and the pool's cached groups outlive the teardown
    mesh = make_mesh(timeout=pm.DEFAULT_TIMEOUT + 1.5)
    group = mesh.group(ROWS)
    ctx = (_driver._plain_graph if route[0] == "plain" else _driver._capture_at)
    solves = {"rows": make_sharded_solver(solver, A, mesh=mesh, **kwargs),
              "alone": make_sharded_solver(solver, A, mesh=Mesh.of_one(mesh.device), **kwargs)}
    slots = {which: inspect.getclosurevars(s).nonlocals["slot"] for which, s in solves.items()}
    names = {id(slot): which for which, slot in slots.items()}
    order, kept = [], {}
    for which, solve in solves.items():
        with ctx(*route[1:]):
            solve(b)
        kept[which] = [_driver.LAST_GRAPH.get("kept")]
    held = {which: slot in pm._HELD for which, slot in slots.items()}
    if route[0] == "plain":
        pm.hold(slots["rows"], mesh)
    release, destroy = _driver.Kept.release, pm._destroy

    def releasing(slot):
        order.append(("release", names.get(id(slot)), slot.loop is not None))
        return release(slot)

    def destroying(g=None):
        order.append(("destroy", "rows" if g is group else repr(g)))
        return destroy(g)

    with mock.patch.object(_driver.Kept, "release", releasing), \
            mock.patch.object(pm, "_destroy", destroying):
        if how == "destroy":
            dist.destroy_process_group(group)
        else:
            pm.release_kept(group)
            pm._destroy(group)
    for which, slot in slots.items():
        kept[which].append(slot.loop is not None)
    with ctx(*route[1:]):
        solves["alone"](b)
    return {"order": order, "held": held, "kept": kept, "again": _driver.LAST_GRAPH.get("kept"),
            "cached": any(g is group for g in pm._GROUPS.values())}
