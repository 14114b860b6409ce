"""Callbacks on the ``while_loop`` driver's graph route, on the CPU.

The reference fires ``callback(x, r)`` from inside its compiled loop (an
ordered ``jax.debug.callback``) and a ``ShardMonitor`` with ``(k, global
resnorm)``, ``numsteps + 1`` times (``tests/test_backends.py``'s
``test_compiled_callback_contract``).  The port's graph route copies a
step's callback arguments into a ring on the device and fires the user's
callback on the host after each read of the stop flag, a monitor from the
history rows read with the flag (``krylov_tpu_torch._driver``).  Here its
plain twin (``_driver._plain_graph``) runs the same guarded steps with each
IF node's flag read on the host, for the eleven solvers of that reference
test and ``cg_pipelined``, ``cg_block``, ``chebyshev`` and ``gcr``, with
graphs of 3, 8 and 5 steps (steps ending anywhere in a replay): the solve
takes the graph route, the callback fires ``numsteps + 1`` times, each
``(x, r)`` ``torch.equal`` to the host-stepped loop's in order, the tensors
a callback keeps unchanged by later replays, and the calls within float64
round-off of the reference's compiled loop's (``CALL_TOL`` of the largest
value each argument takes over the calls).  Then an early success
(``bicgstab``, and a synthetic method with its early step anywhere in a
replay), a failed explicit recheck with a monitor, the other capturable
methods' callbacks, and a solver built once (``make_sharded_solver`` on a
world of one gloo rank) with a monitor over three runs.  The reference runs
compiled, each solve once (``functools.cache``).
"""

import functools
from unittest import mock
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu_torch import _driver
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

# the calls against the reference's: float64 round-off of two orders of
# operations over 30-60 steps, relative to the largest value an argument
# takes over the calls (symmlq's Lanczos vector after 27 steps: 1e-12; the
# others 2e-15 at most; a residual falls by 1e-10)
CALL_TOL = 1e-10
PLANS = [(2, 3, 1), (3, 8, 4), (5, 5, 3)]


def _shifted_poisson(g, shift=0.5, skew=0.0):
    A = scipy.sparse.diags([-1.0, -1.0, 4.0 + shift, -1.0, -1.0], [-g, -1, 0, 1, g],
                           shape=(g * g, g * g), format="csr")
    if skew:  # nonsymmetric
        A = A + scipy.sparse.diags([skew, -skew], [1, -1], shape=A.shape)
    return A.tocsr()


# the eleven solvers of the reference's compiled-callback test, then the
# solvers whose step depends on its step number
SOLVERS = ("cg", "gmres", "gmres householder", "gmres cgs", "minres", "bicgstab", "qmr",
           "tfqmr", "symmlq", "jacobi", "lsqr", "cg_pipelined", "cg_block", "chebyshev", "gcr")
_NONSYMMETRIC = ("gmres", "bicgstab", "qmr", "tfqmr", "lsqr", "gcr")


def _case(name):
    """``(port solve, reference solve)``, each ``solve(callback)`` returning
    ``(x, info)``: an 81-row shifted Poisson, made nonsymmetric for the
    nonsymmetric solvers (``lsqr``'s normal equations: a larger shift);
    ``symmlq`` cut at 30 steps: its reported norm, of the Lanczos vector,
    vanishes only once the Krylov space is exhausted, and that vector is
    round-off there."""
    solver = name.split()[0]
    A = _shifted_poisson(9, shift=4.0 if solver == "lsqr" else 0.5,
                         skew=0.1 if solver in _NONSYMMETRIC else 0.0)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    kw = dict(tol=1e-10, backend="while_loop")
    if name.startswith("gmres "):
        kw["ortho"] = name.split()[1]
    if solver == "jacobi":
        kw.update(omega=0.9, maxiter=60)
    elif solver == "symmlq":
        kw["maxiter"] = 30
    elif solver == "chebyshev":
        # the Poisson's spectrum: 4.5 -+ 4 cos(pi / 10)
        kw["eigenvalue_estimates"] = (4.5 - 4 * np.cos(np.pi / 10), 4.5 + 4 * np.cos(np.pi / 10))
    elif solver == "cg_pipelined":
        kw["replace_every"] = 5  # a replacement inside the replays
    elif solver == "cg_block":
        kw["replace_every"] = 4
    port, ref = getattr(kt, solver), getattr(krylov_tpu, solver)
    return (lambda cb: port(A, b, callback=cb, **kw),
            lambda cb: ref(A, b, callback=cb, **kw))


@functools.cache
def _reference(name):
    """The reference's compiled-loop calls (host arrays) and its info."""
    calls = []
    _, info = _case(name)[1](lambda *a: calls.append([np.array(v) for v in a]))
    return calls, info


def _recorded(solve, ctx):
    """``(info, calls, kept)`` of ``solve(callback)`` under ``ctx``: the
    calls' arguments cloned when they came, and the tensors themselves."""
    calls, kept = [], []

    def callback(*args):
        calls.append([a.clone() for a in args])
        kept.append(args)

    with ctx:
        _, info = solve(callback)
    return info, calls, kept


def _same_calls(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w)), j


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", SOLVERS)
def test_callbacks_fire_in_order_from_the_graph_route(name, plan):
    solve = _case(name)[0]
    host, host_calls, _ = _recorded(solve, _driver._host_stepped())
    _driver.reset_counts()
    info, calls, kept = _recorded(solve, _driver._plain_graph(*plan))
    c = dict(_driver.COUNTS)
    assert c["graph_route"] == c["captures"] == 1 and c["host_stepped"] == 0, c
    assert c["uncapturable"] == 0 and c["graph_steps"] > 0, c
    assert len(calls) == info.numsteps + 1 == host.numsteps + 1
    # the ring: two batches of a read's steps and the spare slot
    _, U, R = plan
    assert _driver.LAST_GRAPH["ring_mb"] == (2 * U * R + 1) * sum(
        a.numel() * a.element_size() for a in calls[0]) / 2**20
    _same_calls(calls, host_calls)
    # what a callback keeps is its own: no later replay wrote it
    _same_calls([list(a) for a in kept], calls)
    ref_calls, ref = _reference(name)
    assert info.numsteps == int(ref.numsteps) and len(ref_calls) == len(calls)
    scale = [max(np.max(np.abs(w[i])) for w in ref_calls) for i in range(2)]
    for j, (g, w) in enumerate(zip(calls, ref_calls)):
        for a, v, m in zip(g, w, scale, strict=True):
            np.testing.assert_allclose(a.numpy(), v, rtol=0.0, atol=CALL_TOL * m,
                                       err_msg=f"call {j}")


# --- early success, failed rechecks, the other methods -------------------------------


def _bicgstab_early(callback):
    """``bicgstab`` with ``Ml = diag(A)^-1`` on a shifted Poisson: its
    mid-step probe ends the solve (early_success)."""
    A = _shifted_poisson(17)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    Ml = kt.DiagonalOperator(torch.from_numpy(1.0 / A.diagonal()))
    return kt.bicgstab(A, b, Ml=Ml, tol=1e-8, backend="while_loop", callback=callback)


def _monitored(solve, ctx):
    """``(info, [(k, resnorm)])`` of ``solve(monitor)`` under ``ctx``."""
    seen = []
    monitor = _driver.ShardMonitor(lambda k, rn: seen.append((k, rn)))
    with ctx:
        _, info = solve(monitor)
    return info, seen


def _same_monitor(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert isinstance(a, np.ndarray) and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize("plan", [(2, 8, 4), (3, 1, 1), (5, 5, 3)])
def test_an_early_success_fires_nothing_for_its_step(plan):
    """The early step overwrites the last history entry and fires no call;
    the step before it fired with its own arguments, and a monitor with
    its recurrence value, though the early step overwrote that entry on
    the device before the host read it."""
    host, host_calls, _ = _recorded(_bicgstab_early, _driver._host_stepped())
    _driver.reset_counts()
    info, calls, _ = _recorded(_bicgstab_early, _driver._plain_graph(*plan))
    assert info.success and _driver.COUNTS["rechecks"] == 0 and _driver.COUNTS["captures"] == 1
    assert len(calls) == info.numsteps + 1
    _same_calls(calls, host_calls)
    host, host_seen = _monitored(_bicgstab_early, _driver._host_stepped())
    info, seen = _monitored(_bicgstab_early, _driver._plain_graph(*plan))
    assert len(seen) == info.numsteps + 1 and seen[-1][0] == info.numsteps
    _same_monitor(seen, host_seen)
    # the history's last entry is the early step's; the monitor saw step k's
    assert seen[-1][1] != info.resnorms[-1]


class _S(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor
    early_success: torch.Tensor


def _early_method(early_at):
    """A synthetic capturable method whose step ``early_at`` exits early."""

    def step(s, criterion):
        x = s.x + 1
        return _S(x, s.resnorm * 0.5 + 0.01 * x, x == early_at)

    return _driver.Method(step=step, xk=lambda s: s.x, callback_args=lambda s: (s.x, s.resnorm),
                          capturable=True)


@pytest.mark.parametrize("early_at,maxiter", [(3, 20), (4, 20), (11, 20), (9, 9), (-1, 19)])
def test_an_early_step_anywhere_in_a_replay(early_at, maxiter):
    """Graphs of 3 steps, 2 replays a read after 2 host steps: the early
    step as the rehearsal's successor, inside a replay, at a batch's first
    step, at maxiter, and none; the callback's and the monitor's calls the
    host-stepped loop's."""
    s0 = _S(torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64),
            torch.tensor(False))
    method = _early_method(float(early_at))
    runs = []
    for ctx in (_driver._host_stepped, lambda: _driver._plain_graph(2, 3, 2)):
        calls, seen = [], []
        for callback in (lambda *a: calls.append([t.clone() for t in a]),
                         _driver.ShardMonitor(lambda k, rn: seen.append((k, rn)))):
            with ctx():
                out = _driver.run(s0, method, tol=1e-30, atol=0.0, maxiter=maxiter,
                                  callback=callback, backend="while_loop")
        runs.append((out, calls, seen))
    ((_, okh, kh, hh), host_calls, host_seen), ((_, okg, kg, hg), calls, seen) = runs
    assert (okg, kg) == (okh, kh)
    np.testing.assert_array_equal(hg, hh)
    # the solver fires call 0 itself: the driver, the steps' calls
    assert len(calls) == kg and len(seen) == kg + 1
    _same_calls(calls, host_calls)
    _same_monitor(seen, host_seen)


def test_a_monitor_saw_the_recurrence_value_a_failed_recheck_overwrote():
    """``cg`` whose recurrence dips below 3e-16 while the explicit residual
    does not follow: every failed recheck overwrites the history's last
    entry and resumes the same graph; the monitor saw each step's
    recurrence value, as the host-stepped loop's did."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((200, 200)))
    A = torch.from_numpy(Q @ np.diag(np.geomspace(1.0, 10.0, 200)) @ Q.T)
    b = torch.from_numpy(rng.standard_normal(200))

    def solve(monitor):
        return kt.cg(A, b, tol=3e-16, atol=0.0, maxiter=77, backend="while_loop",
                     callback=monitor)

    host, host_seen = _monitored(solve, _driver._host_stepped())
    _driver.reset_counts()
    info, seen = _monitored(solve, _driver._plain_graph(3, 4, 2))
    c = dict(_driver.COUNTS)
    assert c["captures"] == 1 and c["rechecks"] > 2 and c["graph_route"] == 1, c
    assert info.numsteps == 77 and len(seen) == 78
    _same_monitor(seen, host_seen)
    overwritten = [k for k, rn in seen if rn != info.resnorms[k]]
    assert overwritten and overwritten[-1] == 77


@pytest.mark.parametrize("name", ["bicg", "cgs", "cgr", "richardson", "cg M",
                                  "gmres mgs2 (N, 2)", "cg arnoldi", "tfqmr M"])
def test_the_other_methods_callbacks_take_the_graph_route(name):
    """The capturable methods' callback arguments on the device counter,
    screened: no host read, the graph route, the host-stepped loop's calls
    bit for bit (a blocked right-hand side, a preconditioner, the device
    Arnoldi buffers)."""
    solver = name.split()[0]
    A = _shifted_poisson(9, skew=0.1 if solver in ("bicg", "cgs", "tfqmr", "gmres") else 0.0)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(81) if "(N, 2)" not in name else rng.standard_normal((81, 2))
    kw = dict(tol=1e-10, backend="while_loop")
    if name == "richardson":
        kw.update(omega=0.2, maxiter=60)
    elif name.endswith(" M"):
        kw["M"] = kt.DiagonalOperator(torch.from_numpy(1.0 / A.diagonal()))
    elif solver == "gmres":
        kw["ortho"] = "mgs2"
    elif name == "cg arnoldi":
        kw["return_arnoldi"] = True
    fn = getattr(kt, solver)

    def solve(cb):
        return fn(A, b, callback=cb, **kw)

    host, host_calls, _ = _recorded(solve, _driver._host_stepped())
    _driver.reset_counts()
    info, calls, kept = _recorded(solve, _driver._plain_graph(3, 4, 2))
    c = dict(_driver.COUNTS)
    assert c["captures"] == 1 and c["uncapturable"] == c["host_stepped"] == 0, c
    assert len(calls) == info.numsteps + 1 == host.numsteps + 1
    _same_calls(calls, host_calls)
    _same_calls([list(a) for a in kept], calls)


def test_a_callback_that_reads_the_host_runs_from_the_host():
    """The user's callback is never called while a step is captured,
    rehearsed or screened: one that reads its arguments on the host (a
    float of the residual norm) still lets the solve replay its graph."""
    seen = []
    A = _shifted_poisson(9)
    b = np.random.default_rng(5).standard_normal(81)
    _driver.reset_counts()
    with _driver._plain_graph(3, 4, 2):
        _, info = kt.cg(A, b, tol=1e-10, backend="while_loop",
                        callback=lambda x, r: seen.append(float(torch.linalg.vector_norm(r))))
    c = dict(_driver.COUNTS)
    assert c["captures"] == 1 and c["uncapturable"] == 0 and c["graph_steps"] > 0, c
    assert len(seen) == info.numsteps + 1


def test_a_failed_capture_with_a_callback_raises_naming_the_solver():
    """A callback whose method gives no tensor to copy into the ring: the
    capture fails and the solve raises, naming the solver (the function
    that built the step) and the cause; it is not rerun on the host."""

    class _X(NamedTuple):
        x: torch.Tensor
        resnorm: torch.Tensor

    def halving(s, criterion):
        return _X(s.x + 1, s.resnorm * 0.5)

    method = _driver.Method(step=halving, xk=lambda s: s.x,
                            callback_args=lambda s: (s.x, "not a tensor"), capturable=True)
    s0 = _X(torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
    calls = []
    _driver.reset_counts()
    with _driver._plain_graph(3, 2, 2), pytest.raises(
            RuntimeError, match="^test_a_failed_capture.*failed to capture.*not a tensor"):
        _driver.run(s0, method, tol=1e-30, atol=0.0, maxiter=20,
                    callback=lambda *a: calls.append(a), backend="while_loop")
    # the two host steps before the rehearsal fired theirs; the rehearsal raised
    assert len(calls) == 2 and _driver.COUNTS["host_stepped"] == 0


# --- a solver built once -----------------------------------------------------------------


def test_a_built_solver_fires_its_monitor_in_every_run():
    """``make_sharded_solver`` on a world of one gloo rank with a
    monitor: the first run captures, the later two replay the kept graph
    from step 0, and each run fires ``numsteps + 1`` calls, the
    host-stepped runs' own."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel

    A = ts.poisson_2d(16, dtype=np.float64, device="cpu")
    rng = np.random.default_rng(6)
    rhs = [torch.from_numpy(rng.standard_normal((16, 16)) * s) for s in (1.0, 0.3, 0.01)]
    seen = []
    mesh = parallel.make_mesh(device="cpu")
    try:
        run = parallel.make_sharded_solver(kt.cg, A, mesh=mesh, tol=1e-8, atol=1e-12,
                                           maxiter=60, callback=lambda k, rn: seen.append((k, rn)))
        runs = {}
        for route, ctx in (("host", _driver._host_stepped), ("graph", _driver._plain_graph)):
            runs[route] = []
            for b in rhs:
                seen.clear()
                _driver.reset_counts()
                with ctx(3, 2, 2) if route == "graph" else ctx():
                    _, info = run(b)
                runs[route].append((info, list(seen), dict(_driver.COUNTS),
                                    _driver.LAST_GRAPH.get("kept")))
    finally:
        dist.destroy_process_group()
    for j, ((h, h_seen, _, _), (g, g_seen, c, kept)) in enumerate(zip(*runs.values())):
        assert g.numsteps == h.numsteps and len(g_seen) == g.numsteps + 1, j
        np.testing.assert_array_equal(g.resnorms, h.resnorms)
        _same_monitor(g_seen, h_seen)
        assert kept == ("captured" if j == 0 else "replayed"), (j, kept)
        assert c["captures"] == (j == 0) and c["kept_runs"] == (j > 0), (j, c)
        if j:
            assert c["host_steps"] == 0 and c["graph_steps"] == g.numsteps, (j, c)


# --- the cost rule ---------------------------------------------------------------------


def _costs(**kw):
    base = dict(steps_left=1000, host_s=350e-6, launch_s=300e-6, device_s=90e-6, copy_s=26e-6,
                clone_s=26e-6)
    return _driver.Costs(**{**base, **kw})


def test_the_rule_counts_the_ring_and_pays_the_callback_on_both_routes():
    """A step's ring copies make a captured step dearer: enough of them
    and no capture repays.  The callback's host time is paid on both
    routes (on the graph route while the next batch replays), so it moves
    no plan."""
    c = _costs()
    assert _driver._plan(c) is not None
    assert _driver._plan(c._replace(ring_s=250e-6)) is None
    for callback_s in (1e-6, 90e-6, 5e-3):
        assert _driver._plan(c._replace(callback_s=callback_s)) == _driver._plan(c)


@pytest.mark.parametrize("arg_bytes,fit", [(0, None), (8 << 20, 64), (64 << 20, 8),
                                           (256 << 20, 2), (1 << 30, 0)])
def test_the_ring_fits_its_bytes(arg_bytes, fit):
    """Two batches of a read's ``U R`` steps' callback arguments hold at
    most ``RING_STATE_SHARE`` times the state's bytes (here 256 MiB): wider
    arguments take fewer replays a read and steps a graph, and arguments
    too wide for two steps take no capture."""
    state_bytes = 256 << 20
    plan = _driver._plan(_costs(arg_bytes=arg_bytes, state_bytes=state_bytes))
    if fit == 0:
        assert plan is None
        return
    U, R = plan
    assert U * R == min(_driver.STEPS_PER_READ, fit or _driver.STEPS_PER_READ)
    assert 2 * U * R * arg_bytes <= _driver.RING_STATE_SHARE * state_bytes


@pytest.mark.parametrize("callback_s,held", [(0.0, 0), (3e-3, 1)])
def test_a_dear_callback_makes_the_hold_worth_its_share(callback_s, held):
    """The hold costs about a step's launches (0.9 ms): more than
    ``MEASURE_SHARE`` of the ~30 ms of host steps still to go, but not of
    the host steps and callbacks still to go when the callback takes 3 ms
    a step; the hold then times the step and the capture follows."""
    A = _shifted_poisson(9)
    b = np.random.default_rng(7).standard_normal(81)
    calls = []
    costs = lambda left: _costs(steps_left=left, host_s=1e-3, launch_s=0.9e-3,  # noqa: E731
                                device_s=0.1e-3, copy_s=5e-5, clone_s=5e-5,
                                callback_s=callback_s)
    _driver.reset_counts()
    with mock.patch.object(_driver, "FIRST_CHECK", 3), _driver._plain_graph(costs=costs):
        _, info = kt.cg(A, b, tol=1e-10, backend="while_loop",
                        callback=lambda *a: calls.append(1))
    c = dict(_driver.COUNTS)
    assert _driver.LAST_GRAPH["decisions"][0][2] is not None  # at no device time
    assert c["held_steps"] == c["captures"] == held, c
    assert len(calls) == info.numsteps + 1
