"""A solver built once keeps its captured graph across its runs, on the CPU.

``parallel.make_sharded_solver`` is the reference's build-once, solve-many
solver (its ``jax.jit`` program is compiled once).  On the ``while_loop``
graph route the port's built solver captures its graph in its first run
and keeps it with its buffers; every later run writes its initial state
into them and replays from step 0 (``_driver.Kept``).  Four gloo ranks of
one module-scoped pool run each method the graph route takes through one
built solver, on the route's plain twin (``_driver._plain_graph``, which
replays the first run's step as the card's graph does): three right-hand
sides (one that ends at ``maxiter``, one with ``x0``, one that converges in
a few steps), each bit-equal to the host-stepped loop, one capture, no
host step after it, and each run held to the reference's
``make_sharded_solver`` on four virtual devices.  Then: a step that reads a
tensor made for one solve outside its state is refused a kept graph; the
ranks' differing costs give one kept plan; a built solver that the rule
keeps host-stepped never decides again; and no collective sits two
conditional levels deep.
"""

import functools
from typing import NamedTuple

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import _driver
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.parallel import _spawn
from tests.test_torch_parallel import RANKS, held, pool  # noqa: F401

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

N = 16  # the grid's side
PLAN = ("plain", 3, 2, 2)  # three host steps, then graphs of two steps, two replays a read
MAXITER = 20  # below the random right-hand side's steps to ATOL
TOL, ATOL = 1e-12, 1e-4

_GRID = dict(cg={}, cg_pipelined=dict(replace_every=5), minres={}, bicg={}, bicgstab={},
             cgs={}, qmr={}, tfqmr={}, gmres={}, gmres_cgs=dict(ortho="cgs"), symmlq={},
             gcr={}, cgr={}, richardson=dict(omega=0.1), jacobi={},
             chebyshev=dict(eigenvalue_estimates=(0.03, 8.0)))
# every method the graph route takes that a sharded solve runs (gmres's
# Householder form needs the default inner product)
METHODS = sorted(_GRID) + ["cg_block", "lsqr"]
# the histories' band against the reference (test_torch_parallel.held's
# 1e-9, but bicgstab's: its mid-step probe carries the two reduction
# orders' rounding apart, 2e-9 after 20 steps of the small right-hand side)
RTOL = dict(bicgstab=1e-8)


def _rhs(seed, k=None):
    """Three right-hand sides: a random one (it ends at MAXITER), one with
    a first iterate, and one a hundred times smaller, which reaches ATOL
    in fewer steps."""
    rng = np.random.default_rng(seed)
    shape = (N * N,) if k is None else (N * N, k)
    return [rng.standard_normal(shape), (rng.standard_normal(shape),
                                         0.1 * rng.standard_normal(shape)),
            0.01 * rng.standard_normal(shape)]


def _case(name):
    """``(solver, port operator, reference operator, right-hand sides,
    keywords)``."""
    kw = dict(tol=TOL, atol=ATOL, maxiter=MAXITER)
    if name == "lsqr":
        sp = scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(N * N,) * 2,
                                format="csr")
        return "lsqr", sp, sp, _rhs(41), kw
    if name == "cg_block":
        return ("cg_block", tst.poisson_2d(N, N), jst.poisson_2d(N, N), _rhs(42, k=3),
                dict(kw, replace_every=5, n_rhs=3))
    solver = "gmres" if name.startswith("gmres") else name
    return (solver, tst.poisson_2d(N, N), jst.poisson_2d(N, N), _rhs(43 + len(name)),
            dict(kw, **_GRID[name]))


@functools.cache
def _ref_runs(name):
    """The reference's built solver on four virtual devices, run on each
    right-hand side in turn."""
    solver, _, Aj, bs, kw = _case(name)
    run = jpar.make_sharded_solver(getattr(krylov_tpu, solver), Aj,
                                   mesh=jpar.make_mesh(n_rows=RANKS), **kw)
    out = []
    for b in bs:
        b, x0 = b if isinstance(b, tuple) else (b, None)
        out.append(run(b, None if x0 is None else np.asarray(x0))[1])
    return out


def _built(pool, name, route=PLAN, **extra):
    solver, At, _, bs, kw = _case(name)
    return pool.submit(_spawn.graph_job, getattr(kt, solver), At, bs, route=route, build=True,
                       **dict(kw, **extra))


def _bit_equal(res):
    """Each run of the route bit-equal to the host-stepped one on every
    rank (the pool checks the ranks agree)."""
    assert res["error"] is None, res["error"]
    (xs_host, xs_route), (is_host, is_route) = res["x"], res["info"]
    for j in range(len(is_host)):
        assert is_route[j][:2] == is_host[j][:2], (j, is_route[j][:2], is_host[j][:2])
        np.testing.assert_array_equal(is_route[j][2], is_host[j][2])
        np.testing.assert_array_equal(xs_route[j], xs_host[j])
    return xs_route, is_route


# ---------------------------------------------------------------------------
# every method: one capture for three runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", METHODS)
def test_a_built_solver_keeps_one_capture(pool, name):
    job = _built(pool, name)
    refs = _ref_runs(name)
    res = job.result()
    xs, infos = _bit_equal(res)
    steps = [i[1] for i in infos]
    assert steps[0] == MAXITER and not infos[0][0], steps  # ends at maxiter
    for p in res["per_rank"]:
        d = p["driver"]
        assert d["captures"] == 1 and d["kept_runs"] == len(infos) - 1, d
        assert d["host_steps"] == PLAN[1] and d["host_stepped"] == 0, d  # none after the capture
        assert p["kept"] == [("captured", None)] + [("replayed", None)] * (len(infos) - 1)
    for x, info, ref in zip(xs, infos, refs):
        held({"x": x, "info": info}, ref, rtol=RTOL.get(name, 1e-9))


# ---------------------------------------------------------------------------
# a step that reads a tensor made for one solve
# ---------------------------------------------------------------------------


class _ToyState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    resnorm: torch.Tensor
    b: torch.Tensor


def _toy(A, b, x0=None, inner=None, tol=1e-5, atol=1e-15, maxiter=None, backend="eager",
         in_state=False):
    """Richardson with a step of 0.1, whose step reads ``b`` from its state
    (``in_state``) or from its closure, a tensor made for one solve."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - A @ x0

    def norm(r):
        return torch.sqrt(inner(r, r))

    def step(s, criterion):
        x = s.x + 0.1 * s.r
        r = (s.b if in_state else b) - A @ x
        return _ToyState(x, r, norm(r), s.b)

    method = _driver.Method(step=step, xk=lambda s: s.x, capturable=True)
    state, ok, k, hist = _driver.run(_ToyState(x0, r0, norm(r0), b), method, tol=tol,
                                     atol=atol, maxiter=maxiter, backend=backend)
    return (state.x if ok else None), kt.Info(ok, state.x, k, hist)


@pytest.mark.parametrize("in_state", [False, True])
def test_a_step_reading_a_tensor_of_one_solve_is_not_kept(in_state):
    """The toy step reads ``b`` from its closure: its graph is refused to
    the kept slot (``LAST_GRAPH["unkept"]`` names the read), so every run
    captures anew and stays right; with ``b`` in its state one capture
    serves every run.  A world of one gloo rank in this process."""
    import torch.distributed as dist

    A = tst.poisson_2d(N, N)
    bs = [torch.as_tensor(np.random.default_rng(s).standard_normal((N, N))) for s in (1, 2, 3)]
    solver = functools.partial(_toy, in_state=in_state)
    mesh = tpar.make_mesh(device="cpu")
    try:
        with _driver._host_stepped():
            hosts = [tpar.sharded_solve(solver, A, b, mesh=mesh, tol=TOL, maxiter=60)[1]
                     for b in bs]
        run = tpar.make_sharded_solver(solver, A, mesh=mesh, tol=TOL, maxiter=60)
        _driver.reset_counts()
        kept = []
        with _driver._plain_graph(*PLAN[1:]):
            for b, host in zip(bs, hosts):
                info = run(b)[1]
                kept.append((_driver.LAST_GRAPH["kept"], _driver.LAST_GRAPH["unkept"]))
                assert info.numsteps == host.numsteps
                np.testing.assert_array_equal(info.resnorms, host.resnorms)
                torch.testing.assert_close(info.xk, host.xk, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
    if in_state:
        assert _driver.COUNTS["captures"] == 1 and kept[0] == ("captured", None), kept
    else:
        assert _driver.COUNTS["captures"] == len(bs) and _driver.COUNTS["kept_runs"] == 0
        assert all(k is None and "made for one solve" in why for k, why in kept), kept


# ---------------------------------------------------------------------------
# the ranks and the rule
# ---------------------------------------------------------------------------


def test_ranks_whose_costs_differ_keep_one_plan(pool):
    """Rank 0's own costs say no capture repays, the others' that one does:
    every rank plans with the largest, captures in the first run and
    replays in the later ones."""
    host_s = (1e-7, 1e-2, 1e-2, 1e-2)
    res = _built(pool, "cg", route=("rule", host_s)).result()
    _bit_equal(res)
    plans = [p["plan"] for p in res["per_rank"]]
    assert plans[0] is not None and all(p == plans[0] for p in plans), plans
    for p in res["per_rank"]:
        assert p["driver"]["captures"] == 1 and p["driver"]["kept_runs"] == 2, p["driver"]
        assert p["kept"][1:] == [("replayed", None)] * 2


def test_a_built_solver_the_rule_keeps_on_the_host_decides_once(pool):
    """A held step whose device time exceeds the host-stepped wall: the
    first run decides (one hold) and stays on the host loop, and the later
    runs run host-stepped with no decision, hold or capture."""
    res = _built(pool, "cg", route=("rule", (1e-3,), 2e-3)).result()
    _bit_equal(res)
    for p in res["per_rank"]:
        d = p["driver"]
        assert d["captures"] == 0 and d["held_steps"] == 1 and d["graph_route"] == 1, d
        assert d["host_stepped"] == 2 and d["kept_runs"] == 0, d
        assert [k for k, _ in p["kept"]] == ["host"] * 3, p["kept"]


# ---------------------------------------------------------------------------
# no collective two conditional levels deep
# ---------------------------------------------------------------------------

# where four NCCL ranks replayed collectives: a guarded step's IF body, and
# a WHILE body inside it (gmres's sweeps); the host steps run at the top
_RAN_ON_FOUR_GPUS = {(), ("if",), ("if", "while")}


@pytest.mark.parametrize("name", ["cg", "cg_pipelined", "cg_block", "gmres_cgs"])
def test_no_collective_sits_in_a_nested_if(pool, name):
    """Each collective a sharded step launches on the plain twin, with its
    conditional nesting: the periodic replacements of ``cg_pipelined`` and
    ``cg_block`` run beside their step's guard (``guard.sibling``), one IF
    deep, as ``cg``'s collectives; nested as before, the record shows
    them two IF bodies deep."""
    solver, At, _, bs, kw = _case(name)
    kw = dict(kw, maxiter=40)
    kw.pop("n_rhs", None)  # a sharded solve takes the columns from b
    job = pool.submit(_spawn.graph_job, getattr(kt, solver), At, bs[0], route=PLAN, **kw)
    res = job.result()
    assert res["error"] is None, res["error"]
    for p in res["per_rank"]:
        paths = {path for _, path in p["nesting"]}
        assert ("if",) in paths and paths <= _RAN_ON_FOUR_GPUS, p["nesting"]
    if name in ("cg_pipelined", "cg_block"):
        nested = pool.run(_spawn.graph_job, getattr(kt, solver), At, bs[0], route=PLAN,
                          unsplit=True, **kw)
        assert all(("exchange", ("if", "if")) in p["nesting"] for p in nested["per_rank"])
