"""The triangular sweeps on the ``while_loop`` graph route, on the CPU.

``gauss_seidel`` (both triangles), ``sor`` and ``ssor`` are capturable on
all three sweep routes: the grid sweeps of a ``GridStencilOperator`` (S1 on
the card), the level-scheduled sweeps of a scipy matrix above
``_DENSE_SWEEP_MAX`` rows (S2 on the card; the cutoff lowered here, in both
packages, as ``tests/test_torch_stationary.py`` lowers it) and the dense
``solve_triangular`` below it.  Each solve runs on the graph route's plain
twin (``_driver._plain_graph()``: every IF node's flag read on the host)
and is held to the host-stepped loop bit for bit (history, step count,
iterate) and to ``krylov_tpu``'s compiled solve (``backend="while_loop"``)
in float64: equal ``numsteps``, histories within ``RTOL``.  With a
callback, the twin fires ``numsteps + 1`` calls, the host loop's values.
The same for ``cg`` + ``SSORSmoother``, ``bicgstab`` + ILU(0) and ``qmr``
+ ``partition_ilu0`` on one gloo rank (a module-scoped pool; the sharded
solve's callback is not checked here), and a solver built once
(``make_sharded_solver``) keeps its graph through ILU(0)-Schwarz and an
``SSORSmoother`` on its grid slab.  Then S2's
schedule, made on the host: every level once and in order, runs of narrow
levels only, and a host model of S2 on the schedule's slot arrays and
launch table (each slot's entries summed in their stored order) held to
the plain version within a few roundings.

The grids are small (16 x 12, and a 40 x 30 CSR whose factors have 69
levels, so that the reference's level sweep is one ``lax.scan``, not an
unrolled program of a stage a level); each reference solve is computed
once (``functools.cache``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import stencil as jst
from krylov_tpu.solvers import stationary as jstat
from krylov_tpu_torch import _driver
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.ops import cuda_triangular as ct
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.ops import triangular as ttri
from krylov_tpu_torch.parallel import _spawn
from krylov_tpu_torch.solvers import stationary as tstat

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

# histories against the reference's: float64, the sweeps' sums in another
# order (doubling steps across a grid row here, a work-efficient scan
# there; test_torch_stationary.py measured ~1e-16 a sweep) over up to ~150
# steps
RTOL = 1e-9
GRID = (16, 12)
LEVEL = (40, 30)  # a true grid's CSR: 1200 rows, ILU and triangle depth 69
MAXITER = 400
TOL = 1e-6


def _grid_csr(M, ny, shift=0.0):
    """The 5-point Laplacian on an ``M x ny`` grid, no coupling across grid
    rows, as a float64 scipy CSR."""
    n = M * ny
    side = -np.ones(n - 1)
    side[ny - 1::ny] = 0.0
    return scipy.sparse.diags([-np.ones(n - ny), side, (4.0 + shift) * np.ones(n), side,
                               -np.ones(n - ny)], [-ny, -1, 0, 1, ny], format="csr")


SP_LEVEL = _grid_csr(*LEVEL, shift=1.0)  # diagonally dominant: GS within ~40 steps
SP_DENSE = _grid_csr(*GRID)
B = {"grid": np.random.default_rng(70).standard_normal(GRID[0] * GRID[1]),
     "level": np.random.default_rng(71).standard_normal(LEVEL[0] * LEVEL[1])}
B["dense"] = B["grid"]

METHODS = {"gauss_seidel": {}, "gauss_seidel upper": dict(lower=False),
           "sor": dict(omega=1.3), "ssor": dict(omega=1.3)}


def _operator(pkg, route):
    if route == "grid":
        if pkg == "jax":
            return jst.poisson_2d(*GRID)
        return tst.poisson_2d(*GRID, dtype=np.float64, device="cpu")
    return SP_LEVEL if route == "level" else SP_DENSE


@pytest.fixture
def cutoff(request, monkeypatch):
    """The dense cutoff of both packages, lowered for the level route."""
    limit = 100 if request.param == "level" else 8192
    monkeypatch.setattr(tstat, "_DENSE_SWEEP_MAX", limit)
    monkeypatch.setattr(jstat, "_DENSE_SWEEP_MAX", limit)
    return request.param


@functools.cache
def _reference(route, method):
    limit = 100 if route == "level" else 8192
    saved = jstat._DENSE_SWEEP_MAX
    jstat._DENSE_SWEEP_MAX = limit
    try:
        name = method.split()[0]
        _, info = getattr(krylov_tpu, name)(_operator("jax", route), jnp.asarray(B[route]),
                                           tol=TOL, maxiter=MAXITER, backend="while_loop",
                                           **METHODS[method])
    finally:
        jstat._DENSE_SWEEP_MAX = saved
    return int(info.numsteps), np.asarray(info.resnorms)


def _counted(solve):
    _driver.reset_counts()
    out = solve()
    return out, dict(_driver.COUNTS)


def _held(solve, ref, callback_solve=None):
    """The twin's solve: one capture, bit-equal to the host-stepped loop,
    held to the reference's ``(numsteps, resnorms)``; with a callback
    ``numsteps + 1`` calls of the host loop's values."""
    with _driver._host_stepped():
        _, host = solve()
    with _driver._plain_graph():
        (_, got), counts = _counted(solve)
    assert counts["graph_route"] == counts["captures"] == 1, counts
    assert counts["host_stepped"] == 0 and counts["uncapturable"] == 0, counts
    assert got.numsteps == host.numsteps and got.success == host.success
    assert torch.equal(torch.as_tensor(np.asarray(got.resnorms)),
                       torch.as_tensor(np.asarray(host.resnorms)))
    assert torch.equal(got.xk, host.xk)
    steps, hist = ref
    assert got.numsteps == steps
    np.testing.assert_allclose(np.asarray(got.resnorms), hist, rtol=RTOL,
                               atol=1e-14 * float(np.max(np.abs(hist[0]))))
    if callback_solve is not None:
        calls = {"host": [], "graph": []}
        with _driver._host_stepped():
            callback_solve(lambda x, r: calls["host"].append(float(torch.linalg.norm(r))))
        with _driver._plain_graph():
            callback_solve(lambda x, r: calls["graph"].append(float(torch.linalg.norm(r))))
        assert len(calls["graph"]) == got.numsteps + 1
        assert calls["graph"] == calls["host"]
    return got


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("cutoff", ["grid", "level", "dense"], indirect=True)
def test_sweep_solvers_take_the_graph_route(cutoff, method):
    route = cutoff
    A = _operator("torch", route)
    b = torch.from_numpy(B[route])
    name = method.split()[0]

    def solve(callback=None):
        return getattr(kt, name)(A, b, tol=TOL, maxiter=MAXITER, backend="while_loop",
                                 callback=callback, **METHODS[method])

    got = _held(solve, _reference(route, method), callback_solve=solve)
    assert got.success


@pytest.mark.parametrize("cutoff", ["grid", "level", "dense"], indirect=True)
def test_the_routes_are_the_sweeps_they_name(cutoff, monkeypatch):
    """A step of the grid route calls S1's wrapper once, of the level route
    S2's (a stacked sweep of 69 levels, past the 64 an unrolled one takes),
    of the dense route neither."""
    calls = {"grid": 0, "level": 0}
    for name, key in (("grid_sweep", "grid"), ("level_sweep", "level")):
        def counting(*args, _f=getattr(ct, name), _k=key):
            calls[_k] += 1
            return _f(*args)

        monkeypatch.setattr(ct, name, counting)
    route = cutoff
    _, info = kt.gauss_seidel(_operator("torch", route), torch.from_numpy(B[route]),
                              tol=0.0, atol=0.0, maxiter=3, backend="while_loop")
    assert calls == {"grid": 3 if route == "grid" else 0, "level": 3 if route == "level" else 0}
    if route == "level":
        sweep = tstat._level_solve(tstat._sparse_for_levels(SP_LEVEL), True, torch.device("cpu"))
        assert isinstance(sweep, ttri.StackedTriangularSweep) and sweep.nlevels == 69


# ---------------------------------------------------------------------------
# the preconditioners built on the sweeps
# ---------------------------------------------------------------------------


@functools.cache
def _reference_precond(case):
    if case == "cg + ssor":
        A = jst.poisson_2d(*GRID)
        _, info = krylov_tpu.cg(A, jnp.asarray(B["grid"]), M=krylov_tpu.SSORSmoother(A, omega=1.5),
                                tol=1e-10, maxiter=200, backend="while_loop")
    else:
        M = krylov_tpu.ILUPreconditioner.from_scipy(_convected(), method="ilu0")
        _, info = krylov_tpu.bicgstab(_convected(), jnp.asarray(B["level"]), Ml=M, tol=1e-10,
                                      maxiter=200, backend="while_loop")
    return int(info.numsteps), np.asarray(info.resnorms)


@functools.cache
def _convected():
    """A nonsymmetric convection-diffusion matrix on the 40 x 30 grid."""
    sp = _grid_csr(*LEVEL, shift=0.3).tolil()
    n = sp.shape[0]
    for i in range(n - 1):
        if sp[i, i + 1] != 0:
            sp[i, i + 1] = -0.6
            sp[i + 1, i] = -1.4
    return sp.tocsr()


@pytest.mark.parametrize("case", ["cg + ssor", "bicgstab + ilu0"])
def test_preconditioners_on_the_sweeps_take_the_graph_route(case):
    if case == "cg + ssor":
        A = _operator("torch", "grid")
        M = kt.SSORSmoother(A, omega=1.5)
        b = torch.from_numpy(B["grid"])

        def solve(callback=None):
            return kt.cg(A, b, M=M, tol=1e-10, maxiter=200, backend="while_loop",
                         callback=callback)
    else:
        M = kt.ILUPreconditioner.from_scipy(_convected(), method="ilu0")
        assert M.nlevels == (69, 69)
        b = torch.from_numpy(B["level"])

        def solve(callback=None):
            return kt.bicgstab(_convected(), b, Ml=M, tol=1e-10, maxiter=200,
                               backend="while_loop", callback=callback)

    got = _held(solve, _reference_precond(case), callback_solve=solve)
    assert got.success


@pytest.fixture(scope="module")
def pool1():
    with _spawn.SPMDPool(1, timeout=120.0) as p:
        yield p


def test_qmr_with_partition_ilu0_on_one_rank_takes_the_graph_route(pool1):
    """``qmr`` + ``partition_ilu0`` (the adjoint sweeps too) through
    ``sharded_solve`` on a world of one gloo rank: the plain twin captures
    once, bit-equal to the host-stepped loop, and matches the reference's
    sharded solve on a one-device mesh."""
    A, b = _convected(), B["level"]
    part = tpar.partition_ilu0(A, 1, with_rmatvec=True)
    res = pool1.submit(_spawn.graph_job, kt.qmr, A, b, route=("plain", 3, 2, 2), mesh_rows=1,
                       mesh_rhs=1, tol=1e-10, maxiter=200, M_partition=part).result()
    assert res["error"] is None, res["error"]
    (x_host, x_graph), (i_host, i_graph) = res["x"], res["info"]
    assert res["driver"]["graph_route"] == res["driver"]["captures"] == 1, res["driver"]
    assert res["driver"]["host_stepped"] == 0
    assert i_graph[0] == i_host[0] and i_graph[1] == i_host[1]
    np.testing.assert_array_equal(i_graph[2], i_host[2])
    np.testing.assert_array_equal(x_graph, x_host)
    _, ref = jpar.sharded_solve(krylov_tpu.qmr, A, jnp.asarray(b), mesh=jpar.make_mesh(n_rows=1),
                                M_partition=jpar.partition_ilu0(A, 1, with_rmatvec=True),
                                tol=1e-10, maxiter=200)
    assert i_graph[0] and i_graph[1] == int(ref.numsteps)
    want = np.asarray(ref.resnorms)
    np.testing.assert_allclose(i_graph[2], want, rtol=RTOL, atol=1e-14 * float(want[0]))


@pytest.mark.parametrize("case", ["bicgstab + partition_ilu0", "cg + SSORSmoother slab"])
def test_a_built_solver_keeps_its_graph_through_the_sweeps(pool1, case):
    """``make_sharded_solver`` on one gloo rank, three right-hand sides: the
    first run captures and keeps its graph, the later two replay it, with
    ILU(0)-Schwarz (``M_partition``) and with an ``SSORSmoother`` built on
    the rank's grid slab (``M_factory``): the screen finds no storage made
    for one solve in either smoother's sweeps."""
    import functools

    rng = np.random.default_rng(74)
    if case == "bicgstab + partition_ilu0":
        A = _convected()
        solver, kw = kt.bicgstab, dict(M_partition=tpar.partition_ilu0(A, 1))
    else:
        A = tst.poisson_2d(*GRID, dtype=np.float64, device="cpu")
        solver, kw = kt.cg, dict(M_factory=functools.partial(kt.SSORSmoother, omega=1.5))
    bs = [rng.standard_normal(A.shape[0]) for _ in range(3)]
    res = pool1.submit(_spawn.graph_job, solver, A, bs, route=("plain", 3, 2, 2), mesh_rows=1,
                       build=True, tol=1e-10, maxiter=30, **kw).result()
    assert res["error"] is None, res["error"]
    assert res["kept"] == [("captured", None), ("replayed", None), ("replayed", None)]
    assert res["driver"]["captures"] == 1 and res["driver"]["kept_runs"] == 2
    (x_host, x_graph), (i_host, i_graph) = res["x"], res["info"]
    for h, g in zip(i_host, i_graph):
        assert h[:2] == g[:2]
        np.testing.assert_array_equal(h[2], g[2])


# ---------------------------------------------------------------------------
# S2's schedule
# ---------------------------------------------------------------------------


def _unstructured_spd(n, k=4, seed=72):
    """``k`` strictly lower neighbours a row drawn from all earlier rows,
    symmetrized, diagonal in [4, 5] (dependency depth O(log n); the widest
    levels hold thousands of rows)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), k)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix((0.2 * rng.standard_normal(rows.shape[0]), (rows, cols)),
                                shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()
    return A


def _sweeps(matrix):
    """``[(sweep, its levels in level_arrays' form)]`` of both factors."""
    if matrix == "ilu0 64^2":
        M = kt.ILUPreconditioner.from_scipy(_grid_csr(64, 64))
        return [(s, _stacked(s)) for s in (M._l, M._u)]
    sp = _unstructured_spd(30000)
    out = []
    for tri, lower, unroll in ((scipy.sparse.tril, True, 64), (scipy.sparse.triu, False, 0)):
        t = tri(sp).tocsr()
        out.append((ttri.make_triangular_solve(t, lower=lower, unroll_threshold=unroll),
                    ttri.level_arrays(t, lower=lower, max_levels=4096)[1]))
    return out


def _stacked(sweep):
    return ct.stacked_levels(*(t.numpy() for t in (sweep.rows, sweep.diag, sweep.dat, sweep.col,
                                                   sweep.lrow)), sweep.n_local)


def _s2_model(sched, slots, b):
    """S2's work on the host from the schedule's slot arrays: launch after
    launch of the table, level after level, each slot's entries summed in
    their stored order."""
    x = np.zeros_like(b)
    lp, ptr = slots["level_ptr"], slots["slot_ptr"]
    for kind, l0, l1, s0, s1 in slots["table"]:
        assert (s0, s1) == (lp[l0], lp[l1])
        for l in range(l0, l1):
            s = np.arange(lp[l], lp[l + 1])
            start, count = ptr[s], ptr[s + 1] - ptr[s]
            acc = np.zeros((len(s),) + b.shape[1:])
            for p in range(int(count.max(initial=0))):
                on = count > p
                e = start[on] + p
                acc[on] += slots["ent_val"][e][:, None] * x[slots["ent_col"][e]]
            rows = slots["slot_row"][s]
            x[rows] = (b[rows] - acc) / slots["slot_diag"][s][:, None]
    return x


def _check_schedule(sweep, levels):
    sched = sweep.schedule
    assert [l for _, l0, l1 in sched.launches for l in range(l0, l1)] == list(
        range(sweep.nlevels))
    for kind, l0, l1 in sched.launches:
        sizes = sched.sizes[l0:l1]
        if kind == "run":
            assert l1 > l0 and max(sizes) <= ct.NARROW_ROWS
        else:
            assert kind == "wide" and l1 == l0 + 1 and sizes[0] > ct.NARROW_ROWS
    b = np.random.default_rng(73).standard_normal((sched.n, 2))
    want = sweep.plain(torch.from_numpy(b))
    # the slot arrays S2 reads, run by the schedule's launches, solve the
    # same triangle as the plain version level by level (float64; sums in
    # the same order, so to a few roundings)
    np.testing.assert_allclose(_s2_model(sched, sched.slots(levels), b), want.numpy(),
                               rtol=0, atol=1e-13 * float(want.abs().max()))
    assert torch.equal(sweep(torch.from_numpy(b)), want)  # on the CPU a call is the plain version


@pytest.mark.parametrize("matrix", ["ilu0 64^2", "unstructured"])
def test_level_schedule_takes_every_level_once_in_order(matrix):
    sweeps = _sweeps(matrix)
    for sweep, levels in sweeps:
        _check_schedule(sweep, levels)
    if matrix == "ilu0 64^2":  # levels of at most 64 rows: one run, one launch each
        assert [s.schedule.launches for s, _ in sweeps] == [[("run", 0, 127)]] * 2
    else:  # the unstructured factor's widest levels take launches of their own
        for s, _ in sweeps:
            assert max(s.schedule.sizes) > ct.NARROW_ROWS
            assert sum(kind == "wide" for kind, _, _ in s.schedule.launches) == sum(
                size > ct.NARROW_ROWS for size in s.schedule.sizes)


def test_level_schedule_alternates_runs_and_wide_levels(monkeypatch):
    """With a narrow bound of 40 rows, ILU(0)'s 64^2 wavefront (levels of 1
    to 64 rows) cuts into a run, 47 wide levels and a run; each factor's
    schedule still takes every level once, in order."""
    monkeypatch.setattr(ct, "NARROW_ROWS", 40)
    for sweep, levels in _sweeps("ilu0 64^2"):
        sweep.schedule = ct.LevelSchedule(levels, sweep.n_local, None, sweep.dat.dtype)
        _check_schedule(sweep, levels)
        kinds = [kind for kind, _, _ in sweep.schedule.launches]
        assert kinds == ["run"] + ["wide"] * 47 + ["run"], kinds
