"""Generic iteration drivers (shared by all solvers).

Counterpart of ``krylov_tpu._driver``: the solve loop exists once, with the
same control-flow contract in both backends:

* convergence criterion ``max(tol * resnorms[0], atol)`` fixed up-front,
* an **explicit-residual double check**: when the recurrence residual norm
  dips below the criterion, the true residual is recomputed and
  *overwrites* the last history entry; success is declared only if the
  explicit value also passes (the overwrite persists even if it does not),
* ``maxiter`` bail-out, ``callback(x, r)`` fired ``numsteps + 1`` times
  (once by the solver before the loop, once per step here), absolute
  resnorm history of shape ``(numsteps + 1, *rhs)``.

Backends:

* ``eager`` — host loop keeping the history as a list of per-step values;
  supports ``on_step`` bookkeeping and is the float64 parity mode on CPU,
* ``while_loop`` — the reference's compiled loop.  It keeps the nested
  structure of the reference's driver: the outer loop runs on the host once
  per convergence event (the start, a dip below the criterion, an early
  success, ``maxiter``) and performs the explicit recheck; the inner loop
  only steps, with the state and a preallocated ``(maxiter + 1, *rhs)``
  history tensor on the solve's device.  Two routes:

  - the **host-stepped loop**: the host launches each step and reads one
    stop flag a step.  It runs every solve on the CPU, with state that
    requires a gradient, of a ``Method`` that is not ``capturable`` (every
    solver's is, the triangular sweeps of ``gauss_seidel``, ``sor`` and
    ``ssor`` included; ``fgmres`` runs a host loop of its own, as the
    reference's eager-only form does), and a sharded solve whose transfers
    are staged through the host;
  - the **graph route**, every other solve on a CUDA device.  It starts as
    the host-stepped loop, launching the same kernels.  After step 24
    (:data:`FIRST_CHECK`), and again when the step count has
    doubled or the solve has outlived the estimate of its steps, the
    steps still to go at the residual's rate so far and the host wall and
    launch time of the two steps before decide, through :func:`_plan`,
    whether a graph could repay its capture even if the device took no
    time at all.  Only then, and only if that costs at most
    :data:`MEASURE_SHARE` of the host time still to go, the next step is
    held behind a sleep until the host has launched it, so that CUDA
    events around it time the device's work alone, and :func:`_plan`
    decides again with that device time.  Every other step is the
    host-stepped loop's, with nothing added.  A capture follows one more
    step from the host, its rehearsal, on the capture's stream and watched
    for any operation that reads a device value on the host (this thread only,
    :func:`._graphs.host_reads`), as is a screen before it: the step's
    device form, run once on a clone of the state with every conditional
    body run once; a read in either keeps the rest of the solve on the
    host-stepped loop, before any capture.  The capture
    records one CUDA graph of ``U`` steps, each behind a conditional IF
    node (:mod:`._graphs`) on a device stop flag: a guarded step runs
    ``method.step``, writes the new resnorm into the history at a device
    counter ``k`` (over entry ``k`` for an early success) and sets the flag
    to ``below | early_success | k >= maxiter``; once it is set the
    remaining steps are skipped on the device.  The host enqueues ``R``
    replays, then reads the flag once.  A failed recheck goes back to
    replaying the same graph.  A solve that ends before its capture ran
    the host-stepped loop's launches, and nothing more.

  A callback fires ``numsteps + 1`` times on both routes, in step order,
  with the host-stepped loop's values, and never while a step is captured,
  rehearsed or screened.  A host step fires it as the host-stepped loop
  does.  A guarded step evaluates ``method.callback_args`` on the device
  counter and copies them into slot ``k mod D`` of a ring of the driver's
  own (an early success's into a spare slot); after each read of the stop
  flag the host fires the user's callback for each step that ran, on
  clones of its slot, once the next ``R`` replays are queued, so the device
  runs them meanwhile (the ring holds two batches, ``D = 2 U R``).  A
  :class:`ShardMonitor` needs no ring: the host reads the history rows of
  the steps that ran with the stop flag, in one copy, before a recheck can
  overwrite them (and a slot that keeps the recurrence value an early
  success overwrites).  The rule counts the ring's copies a step, and
  holds the ring to :data:`RING_STATE_SHARE` times the state's bytes; the
  callback's host time a step, timed on the host steps, counts only in
  whether a held step is worth its share (:class:`Costs`).

  A solver built once for many solves (``make_sharded_solver``) keeps its
  graph across runs in a :class:`Kept` slot (:func:`_keeping`): its first
  run decides after step 3 (:data:`KEPT_FIRST_CHECK`) over that run's steps
  and one more run's, captures, and keeps the graph with its buffers (the
  static state, the history, the criterion, the counters); each later run
  of the same method, state layout, device and ``maxiter`` writes its
  initial state, first history entry and criterion into them and replays
  from step 0, with no host step.  A graph is kept only when the step
  reads no tensor made for one solve outside its state (the screen notes
  every storage it reads); a built solver whose rule says no capture
  repays, or whose first replays cost the device more a step than a
  host-stepped step's wall, runs host-stepped for every run.

  A step gets its step number (:mod:`._steps`): on the host-stepped loop
  the host's count, for branches and loops on the host; in a captured step
  the device counter ``k``, with which a method whose step depends on it
  selects cheap branches with ``torch.where``, runs a dear one (a periodic
  residual replacement) in an IF node and a sweep whose length grows with
  ``k`` (GMRES's Gram-Schmidt and Householder sweeps and rotations, GCR's
  sweep) in a WHILE node, so a captured step records the same kernels at
  any ``maxiter`` and a replayed one does O(k) work.  The launches inside
  such an IF or WHILE body are credited from a device tally of its runs,
  read with the step counter when the replays stop.

  Both routes launch the same kernels in the same order on one stream, so
  their trajectories agree bit for bit.  The graph works on buffers of the
  driver's own, one a state field, cloned from the state, so nothing the
  caller passed in is written.  A capture that fails makes the solve raise
  a ``RuntimeError`` naming the solver and the operation; the solve is
  never rerun on the host-stepped loop.  The kernel wrappers' launch
  counts count launches that ran: a captured step records its launches
  (:func:`._graphs.recording`), and after each read of the flag the
  driver credits them once per step that ran.

Solver-specific state is any object carrying at least ``resnorm``; solvers
with a mid-iteration exit (BiCGSTAB) also carry ``early_success``, a device
bool.  A step that sets it overwrites the last history entry with its
``resnorm`` instead of appending one, fires no callback, and ends the solve
with success and no explicit recheck (the step has just computed an
explicit residual).  The ``while_loop`` backend folds the flag into its
stop flag.  On the graph route the state is a ``NamedTuple`` of tensors.

In a sharded solve (:mod:`krylov_tpu_torch.parallel`) every value the host
reads here, the residual norms, the explicit residual and
``early_success``, comes from inner products reduced over the ranks, so
every rank takes the same branch and meets the others at the next
collective.  On the graph route the ranks also take every decision as one
(:func:`_sharded`): the costs a rank measures differ from another's, so
they agree on the largest, then on whether any rank's rehearsal read the
host and whether every rank captured.  A captured step records its
collectives with its kernels, and every rank replays its graph together
with the others, its stop flag set from the same reduced values.
"""

import contextlib
import functools
import math
import threading
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _steps
from ._steps import DeviceStep, HostStep

EAGER = "eager"
WHILE_LOOP = "while_loop"

# What the drivers did: while_loop solves routed to the host-stepped loop up
# front and to the graph route, graphs captured (the plain twin's too),
# steps launched from the host (every eager and host-stepped step, the
# graph route's steps before its capture) and run by replays, replays,
# reads of a stop flag (one a host step, one a run of replays), host steps
# held behind a sleep to time their device work for the cost rule,
# graph-route solves whose rehearsal step read the host (the rest ran
# host-stepped), explicit-residual rechecks, and the meetings at which a
# sharded solve's ranks agreed on a decision (:func:`_sharded`).
# The runs of a built solver that replayed its kept graph from step 0.
COUNTS = dict.fromkeys(
    ("host_stepped", "graph_route", "captures", "host_steps", "graph_steps", "replays",
     "flag_reads", "held_steps", "uncapturable", "rechecks", "meetings", "kept_runs"), 0)
# The last graph-route solve: its decisions (the host step after which
# each came, the :class:`Costs` it saw and its plan), the plan taken (steps
# a graph ``U``, replays a flag read ``R``) or None, the steps launched from
# the host (before the capture, if any) and the held ones among them (and
# on the card each hold's host seconds from the sleep's launch to the
# step's last, the sleep's seconds and the device seconds timed), the
# operation of the rehearsal step that read the host (or None), the host
# seconds of the steps from the host (before the capture, if any), of the
# decisions, of the capture (without its instantiation), of the
# instantiation, of the replays and of the whole loop; of the host steps'
# seconds, the rehearsal step's (``rehearse_s``), the screen's
# (``screen_s``) and a built solver's walk of its own objects
# (``roots_s``).  A built solver's
# run adds ``kept``: "captured" (this run captured the graph it keeps),
# "replayed" (it replayed the kept graph), "host" (the rule keeps the solver
# host-stepped), or None, with ``unkept`` saying why a capture was not kept,
# and ``replay_step_s``, the device seconds a replayed step took in the
# capturing run (None on the plain twin).
LAST_GRAPH = {}

_ROUTES = threading.local()  # .forced: this thread's stack of (route, plan); .ranks; .kept


class Ranks(NamedTuple):
    """The ranks of a sharded solve that take its graph route's decisions
    as one: a mesh's rows group (:func:`_sharded`)."""

    group: Any  # the torch.distributed process group
    ranks: tuple  # its global ranks, in group order
    index: int  # this rank's place in ``ranks``
    device: torch.device  # where the group's collectives take their tensors


@contextlib.contextmanager
def _forced(route, plan=None):
    stack = _ROUTES.__dict__.setdefault("forced", [])
    stack.append((route, plan))
    try:
        yield
    finally:
        stack.pop()


def _host_stepped():
    """Within: every ``while_loop`` solve of this thread runs the
    host-stepped loop (the graph route's plain version beside it; the
    sharded solves)."""
    return _forced("host")


def _plain_graph(after=2, steps=2, replays=2, costs=None):
    """Within: a ``while_loop`` solve that the graph route would take runs
    its loop on any device with each IF node's flag read on the host,
    nothing captured (the CPU tests' twin of the graph): ``after`` steps
    from the host (at least 2, and more while the state's types change),
    the last one the capture's rehearsal, then replays of ``steps`` guarded
    steps, ``replays`` a read of the flag.  ``costs``: instead of that plan,
    the cost rule's, with ``costs(steps_left)`` (a :class:`Costs`) in place
    of the measurements at each decision."""
    return _forced("plain", (after, steps, replays, costs))


def _capture_at(after=2, steps=2, replays=2):
    """Within: a ``while_loop`` solve on a CUDA device that the graph route
    takes captures with this plan (see :func:`_plain_graph`) whatever its
    costs: the card's tests of the graph at sizes no capture repays."""
    return _forced("capture", (after, steps, replays, None))


@contextlib.contextmanager
def _sharded(ranks):
    """Within: every ``while_loop`` solve of this thread is one rank's part
    of a sharded solve over :class:`Ranks` ``ranks`` (:mod:`.parallel`),
    whose steps run collectives.  On the graph route its ranks agree, at
    one small collective and one host read each, on every decision's
    :class:`Costs` (the largest of each), on whether any rank's rehearsal
    read the host and on whether every rank captured, so that every rank
    takes one plan, captures together and replays together.  A rank alone
    meets no one."""
    stack = _ROUTES.__dict__.setdefault("ranks", [])
    stack.append(ranks)
    try:
        yield
    finally:
        stack.pop()


def _ranks():
    stack = getattr(_ROUTES, "ranks", None)
    return stack[-1] if stack else None


class Kept:
    """What a solver built once for many solves keeps of the graph route
    between its runs (:func:`_keeping`).  ``roots``: the built solver's own
    objects (its operator, preconditioner, reductions); the tensors they
    reach outlive a run, every other tensor a step reads outside its state
    belongs to one solve."""

    def __init__(self, roots):
        self.roots = roots
        self.key = None  # what the kept loop, or the host-stepped decision, holds for
        self.loop = None  # the kept _GraphLoop, its graph captured
        self.host = False  # the rule keeps this solver host-stepped for every run
        self.why = None  # why the last capture was not kept

    def release(self):
        """Drop the kept graph, its pool and its buffers."""
        loop, self.loop, self.key, self.host = self.loop, None, None, False
        if loop is not None:
            loop.release()


@contextlib.contextmanager
def _keeping(slot):
    """Within: every ``while_loop`` solve of this thread that takes the
    graph route keeps its graph in :class:`Kept` ``slot`` and replays it in
    the next solve of the same key (see the module docstring)."""
    stack = _ROUTES.__dict__.setdefault("kept", [])
    stack.append(slot)
    try:
        yield
    finally:
        stack.pop()


def _slot():
    stack = getattr(_ROUTES, "kept", None)
    return stack[-1] if stack else None


def _key(method, state0, maxiter, plain, forced, callback=None):
    """What a kept graph is valid for: the method (its step's code; a built
    solver's keywords are its own), the state's layout and device,
    ``maxiter``, the route, a forced plan and the kind of callback (a ring's
    graph writes one, a monitor's an early success's slot)."""
    step = getattr(method.step, "__wrapped__", method.step)
    kind = (None if callback is None else "monitor" if isinstance(callback, ShardMonitor)
            else "ring" if method.callback_args is not None else None)
    return (getattr(step, "__code__", step), _layout(state0), state0.resnorm.device, maxiter,
            plain, None if forced is None else forced[:3], kind)


def _meet(ranks, values):
    """The largest of each of ``values`` over ``ranks`` (a :class:`Ranks`
    of several): one small collective and one host read; ``values`` alone
    with no ranks."""
    if ranks is None:
        return list(values)
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=ranks.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ranks.group)
    COUNTS["meetings"] += 1
    return t.tolist()


def _several(ranks):
    return ranks if ranks is not None and len(ranks.ranks) > 1 else None


def reset_counts():
    for key in COUNTS:
        COUNTS[key] = 0


class ShardMonitor:
    """Per-iteration observability hook for sharded solves.

    Counterpart of ``krylov_tpu._driver.ShardMonitor``.  In a sharded solve
    ``x`` and ``r`` are rank-local slabs, and a callback would fire once a
    rank, so the drivers recognize this wrapper and call ``fn(k,
    resnorm)`` on rank 0 of ``group`` only: ``k`` is the iteration index
    (0 for the initial residual) and ``resnorm`` (a host array) the global
    recurrence residual norm appended to the history at step ``k``,
    already reduced over the ranks.  The explicit-residual double check
    may later overwrite history entries; the hook saw the recurrence
    value, as the reference's callback does.  ``fn`` is called
    ``numsteps + 1`` times, in step order, on both routes of
    ``while_loop``: the graph route reads the rows of the steps its
    replays ran with the stop flag and calls ``fn`` from the host.
    ``group=None`` fires on every process.
    """

    def __init__(self, fn, group=None):
        import torch.distributed as dist

        self.fn = fn
        self.active = group is None or dist.get_rank(group) == 0

    def __call__(self, *args):
        # the solvers' pre-loop ``callback(x0, r0)`` lands here with
        # rank-local vectors; the driver fires (0, resnorm0) itself
        return None

    def fire(self, k, resnorm):
        if self.active:
            self.fn(k, _history(resnorm))


class Method(NamedTuple):
    """Hooks describing one Krylov method to the generic drivers."""

    step: Callable[[Any, Any], Any]  # (state, criterion) -> state
    xk: Callable[[Any], Any]  # state -> current solution iterate
    # recompute the true residual norm of an iterate; None disables the
    # double-check
    explicit_resnorm: Optional[Callable[[Any], Any]] = None
    # state -> args tuple for the user callback
    callback_args: Optional[Callable[[Any], tuple]] = None
    # eager-only bookkeeping hook, e.g. cg's return_arnoldi basis collection
    on_step: Optional[Callable[[Any, Any], None]] = None
    # True when a step may be captured once and replayed: it reads nothing
    # on the host and keeps no host-side state that a replay would freeze.
    # Only such methods take the graph route.
    capturable: bool = False
    # the hooks' form.  False: the reference's ``step(state, criterion)``,
    # ``xk(state)``, ``callback_args(state)``.  True: ``step(state,
    # criterion, ctl)`` with a :mod:`._steps` control (``ctl.k`` the steps
    # before it: the host's count, or on the graph route the device
    # counter), ``xk(state, k)`` and ``callback_args(state, k)`` with the
    # step count.  The drivers call the second form (:func:`_counted`)
    counted: bool = False
    # True when a graph must hold an even number of steps: the step
    # alternates a field between two buffers of its own (cg_stencil's
    # direction), so after an even number it is back in the first
    even_steps: bool = False


def run(
    state0,
    method: Method,
    *,
    tol: float,
    atol: float,
    maxiter: int,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Drive ``method`` to convergence.

    Returns ``(state, success, numsteps, resnorms)`` where ``resnorms`` is a
    host ndarray of shape ``(numsteps + 1, *rhs)``.
    """
    method = _counted(method)
    if backend == EAGER:
        return _run_eager(
            state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback
        )
    if backend == WHILE_LOOP:
        if method.on_step is not None:
            raise ValueError("on_step bookkeeping requires backend='eager'")
        route, plan = _route(state0, method, callback)
        if route == "host":
            COUNTS["host_stepped"] += 1
            return _run_while(
                state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback
            )
        return _run_graph(state0, method, tol=tol, atol=atol, maxiter=maxiter,
                          callback=callback, plain=route == "plain", plan=plan)
    raise ValueError(f"unknown backend {backend!r}")


def _counted(method):
    """``method`` with hooks of the counted form; the reference's form
    gets the step number and drops it."""
    if method.counted:
        return method
    step, xk, args = method.step, method.xk, method.callback_args
    return method._replace(
        step=functools.wraps(step)(lambda state, criterion, ctl: step(state, criterion)),
        xk=lambda state, k: xk(state),
        callback_args=None if args is None else (lambda state, k: args(state)),
        counted=True)


def _route(state0, method, callback):
    """The ``while_loop`` route, decided before any step: ``("host", None)``
    for the host-stepped loop, ``("cuda", plan)`` for the graph route
    (``plan`` a forced ``(after, steps, replays)``, or None for the cost
    rule), ``("plain", plan)`` for its plain twin under
    :func:`_plain_graph`.  A callback takes the route a solve without one
    would: the cost rule weighs what it costs (:class:`Costs`)."""
    stack = getattr(_ROUTES, "forced", None)
    force, plan = stack[-1] if stack else (None, None)
    if force == "host" or not method.capturable:
        return "host", None
    fields = tuple(state0) if isinstance(state0, tuple) and hasattr(state0, "_fields") else ()
    if not fields or not all(isinstance(t, torch.Tensor) for t in fields):
        return "host", None
    if torch.is_grad_enabled() and any(t.requires_grad for t in fields):
        return "host", None
    if force == "plain":
        return "plain", plan
    if all(t.is_cuda for t in fields):
        return "cuda", plan
    return "host", None


# --- the cost rule -----------------------------------------------------------

# The capture's host cost, meant as an upper bound: a base (instantiation,
# the IF nodes' set-up, the first replay's upload) plus the Python of its
# steps, which runs about as fast under capture as launched.  On an H100
# 80GB HBM3 (PERF.md section 6), capture and instantiation took 2.4-4.4 ms
# for four fused CG steps of 0.26 ms launches, 3.9-6.5 ms for four cg + Jacobi
# steps of 0.26 ms, 4.2-6.8 ms for two qmr steps of 1.1 ms, 4.1-11.2 ms
# for eight generic cg steps of 0.57 ms at 4096^2.
CAPTURE_BASE_S = 3.5e-3
CAPTURE_PER_LAUNCH = 1.0
# Device time a guarded step adds: its IF node's kernel, the history
# write and the stop flag's kernels.
GUARD_S = 5e-6
# A copy of a field back into the static state once a replay: a launch,
# then each byte read and written once at what a device-to-device copy
# reaches on an H100.
COPY_LAUNCH_S = 3e-6
COPY_BYTES_PER_S = 2.5e12
# Capture only when the predicted saving is this many times the capture's
# cost: the steps still to go are an estimate.
PAYBACK = 2.0
# Steps a graph may hold, and the steps between two reads of the stop flag.
# More steps a graph amortize a replay's copies back into the static state
# (generic cg at 4096^2: four 67 MB vectors, ~240 us on an H100) but
# cost their Python again at capture; the fused CG ping-pongs its direction
# and needs an even count.  _plan takes the count that saves the most.
GRAPH_STEPS = (1, 2, 4, 8, 16, 32)
STEPS_PER_READ = 32
# The first decision follows this many steps from the host: a shorter solve
# runs the host-stepped loop with nothing added (a capture, 3.5 ms and
# more, seldom repays fewer steps).  The next decision comes when the step
# count has doubled or the solve has outlived the decision's estimate of
# its steps, whichever is later.  A decision takes the lesser host wall of
# the two steps before it, and their launches' host time.
FIRST_CHECK = 24
# A step's device time is measured on a step held behind a sleep until the
# host has launched it (CUDA events around a step that is not held, or held
# for less than its launches, count the device's waits for the host: 36-52 %
# over the device's work on an H100, PERF.md section 6).  The sleep costs
# about the step's launch time; a solve pays it only when its decision at
# no device time says a capture could repay, and only while it is at most
# this share of the host time the solve still has to go.
MEASURE_SHARE = 0.01
# A built solver (:class:`Kept`) decides after this many host steps of its
# first run: the first step pays first uses (allocations, caches), the two
# after it give the rule its two walls.  Its rule counts the steps left of
# that run and one more run of the same length, since building a solver
# says that it is run again, and it holds a step whenever a capture could
# repay: the hold costs less than the capture it decides, once for every
# run.
KEPT_FIRST_CHECK = 3
# the sleep's cycles a second: an H100's clock at up to 2 GHz (a slower
# clock sleeps longer; a sleep too short makes the step look dearer)
HOLD_CYCLES_PER_S = 2.0e9
# A held step whose launches the host ended after its sleep did may time
# the device's waits for the host too: its time is then an upper bound (a
# process's first hold pays first uses inside the sleep: in fresh
# processes on an H100 the first held step of cg + Jacobi timed 1.4-8.5x
# what a covered one did, and the rule kept the solve on the host loop).
# Where that bound still makes a plan it stands; where it refuses one, it
# is dropped and the next step held behind twice the sleep, up to this
# many holds a run.
HOLD_TRIES = 3
# The callback ring's two batches of a read's U * R steps' callback
# arguments hold at most this many times the bytes of the solve's state
# (its spare slot, one step's arguments, comes on top).  Two vectors of
# arguments against a state of four (cg + Jacobi: x, r against x, r, p, z)
# still fill U * R = 4 steps a read, enough for the host to fire a batch's
# callbacks while the next batch replays; wider arguments take fewer
# replays a read, and arguments wider than the state no capture
# (:func:`_plan`).
RING_STATE_SHARE = 4


def _sleep_s(c):
    """The hold's sleep: a step's launch time and 20 us."""
    return c.launch_s + 2e-5


class Costs(NamedTuple):
    """What the graph route has measured of a solve, at a decision."""

    steps_left: int  # steps still to go, from the residual's rate so far
    host_s: float  # host wall of a host-stepped step (launches and flag read)
    launch_s: float  # host time of a step's launches
    device_s: float  # device time of a step, 0 before a step has been held
    copy_s: float  # device time of copying back the fields a step moves
    clone_s: float  # device time of cloning the whole state
    even: bool = False  # Method.even_steps
    # a callback's: the device time of a step's copies of its arguments
    # into the ring and out of it (a clone a call), its host time a step
    # (outside host_s), and the bytes of a step's arguments; the bytes of
    # the solve's state
    ring_s: float = 0.0
    callback_s: float = 0.0
    arg_bytes: int = 0
    state_bytes: int = 0


def _plan(c: Costs):
    """``(U, R)``, steps a graph and replays a read of the stop flag, when
    capturing now repays :data:`PAYBACK` times its cost over the steps
    still to go, else None.  A captured step costs its device time, its
    guard, a ``U``-th of a replay's copies back and its callback's ring
    copies; the capture costs its base, the Python of its ``U`` steps and a
    clone of the state; the step before the capture still runs from the
    host.  A callback's host time does not count: the host-stepped loop
    pays it a step, and the graph route pays it while the next batch
    replays, so it never makes the graph route the dearer one.  A callback
    ring of ``2 U R`` steps' arguments holds at most
    :data:`RING_STATE_SHARE` times the state's bytes."""
    fit = (RING_STATE_SHARE * c.state_bytes // (2 * c.arg_bytes) if c.arg_bytes
           else STEPS_PER_READ)
    best = None
    for U in GRAPH_STEPS:
        if (c.even and U % 2) or U > fit:
            continue
        cost = CAPTURE_BASE_S + U * c.launch_s * CAPTURE_PER_LAUNCH + c.clone_s
        per_step = c.device_s + GUARD_S + c.copy_s / U + c.ring_s
        saving = (c.steps_left - 1) * (c.host_s - per_step)
        if saving >= PAYBACK * cost and (best is None or saving - cost > best[0]):
            best = (saving - cost, U)
    if best is None:
        return None
    U = best[1]
    return U, max(1, min(STEPS_PER_READ, c.steps_left, fit) // U)


def _steps_left(cols, crit, left):
    """Steps a solve still takes to bring every column of its residual
    norm below its criterion at the rate of the second half of its history
    so far, at most ``left``: ``cols`` each column's history (lists of
    floats), ``crit`` each column's criterion.  The rate is the
    least-squares slope of the log of the norms (a Krylov residual falls
    fastest in its first steps); a column that has not shrunk, or a
    criterion of 0, takes all ``left``.  Plain Python: numpy's per-call
    cost on lists this short is most of a decision's."""
    k = len(cols[0]) - 1
    if k < 1:
        return left
    j = k // 2
    t = [i - 0.5 * (k - j) for i in range(k - j + 1)]  # centred: no mean of the logs
    tt = sum(x * x for x in t)
    worst = 0
    for h, c in zip(cols, crit):
        last = h[-1]
        if last <= c:
            continue
        if c <= 0.0 or min(h[j:]) <= 0.0 or not math.isfinite(last):
            return left
        rate = sum(x * math.log(y) for x, y in zip(t, h[j:])) / tt
        if not rate < 0.0:
            return left
        worst = max(worst, math.ceil(math.log(c / last) / rate))
    return min(left, worst)


# --- the loops -----------------------------------------------------------------


def _criterion(resnorm0, tol, atol):
    # atol may be per right-hand-side column (GMRES restarts pass one)
    return torch.maximum(tol * resnorm0, torch.as_tensor(
        atol, dtype=resnorm0.dtype, device=resnorm0.device))


def _history(resnorms):
    """The history as a host ndarray of its own (bfloat16, which numpy
    lacks, as float32): a kept graph writes its buffer again."""
    if resnorms.dtype == torch.bfloat16:
        resnorms = resnorms.float()
    out = resnorms.detach().cpu().numpy()
    return out.copy() if resnorms.device.type == "cpu" else out


def _fire(method, callback, state, k):
    """The callback of step ``k`` (a :class:`ShardMonitor` gets ``(k,
    resnorm)``); returns the arguments a callback took, or None."""
    if isinstance(callback, ShardMonitor):
        callback.fire(k, state.resnorm)
    elif callback is not None and method.callback_args is not None:
        args = method.callback_args(state, k)
        callback(*args)
        return args
    return None


def _run_eager(state, method: Method, *, tol, atol, maxiter, callback):
    resnorms = [state.resnorm]
    criterion = _criterion(resnorms[0], tol, atol)
    if isinstance(callback, ShardMonitor):
        callback.fire(0, state.resnorm)
    success = False
    k = 0
    while True:
        if bool(torch.all(resnorms[-1] <= criterion)):
            if method.explicit_resnorm is None:
                success = True
                break
            rn = method.explicit_resnorm(method.xk(state, k))
            COUNTS["rechecks"] += 1
            resnorms[-1] = rn  # overwrite persists even if the check fails
            if bool(torch.all(rn <= criterion)):
                success = True
                break
        if k == maxiter:
            break

        new_state = method.step(state, criterion, HostStep(k))
        COUNTS["host_steps"] += 1
        if method.on_step is not None:
            method.on_step(state, new_state)
        state = new_state

        early = getattr(state, "early_success", None)
        if early is not None and bool(early):
            resnorms[-1] = state.resnorm
            success = True
            break

        _fire(method, callback, state, k + 1)
        resnorms.append(state.resnorm)
        k += 1

    return state, success, k, _history(torch.stack(resnorms))


def _outer(state, method: Method, inner, *, tol, atol, maxiter, callback, kept=None):
    """The ``while_loop`` backend's outer loop, once per convergence event
    (the start, a dip below the criterion, an early success, ``maxiter``),
    with the explicit recheck; ``inner(state, k, buf, criterion)`` runs
    steps until the next event and returns ``(state, k, early)``.
    ``kept``: the history and criterion buffers of a kept graph, written
    in place."""
    resnorm0 = state.resnorm
    if kept is None:
        buf = resnorm0.new_zeros((maxiter + 1,) + tuple(resnorm0.shape))
        criterion = _criterion(resnorm0, tol, atol)
    else:
        buf, criterion = kept
        criterion.copy_(_criterion(resnorm0, tol, atol))
    buf[0] = resnorm0
    if isinstance(callback, ShardMonitor):
        callback.fire(0, resnorm0)
    early = False
    k = 0
    while True:
        if early:
            ok = True
            break
        ok = bool(torch.all(buf[k] <= criterion))
        if ok and method.explicit_resnorm is not None:
            rn = method.explicit_resnorm(method.xk(state, k)).to(buf.dtype)
            COUNTS["rechecks"] += 1
            buf[k] = rn  # overwrite persists even if the check fails
            ok = bool(torch.all(rn <= criterion))
        if ok or k >= maxiter:
            break
        state, k, early = inner(state, k, buf, criterion)
    return state, ok, k, _history(buf[: k + 1])


def _step_once(method, step, state, k, buf, criterion, callback, noted=None):
    """One step launched from the host (``step``: ``method.step`` or a
    wrapper of it) and its one read of the stop flag: ``(state, k, early,
    stop)``.  ``noted``: a list that takes the callback's host seconds and
    arguments, where it fired."""
    state = step(state, criterion, HostStep(k))
    COUNTS["host_steps"] += 1
    COUNTS["flag_reads"] += 1
    below = torch.all(state.resnorm <= criterion)
    early = getattr(state, "early_success", None)
    if early is not None:
        # one read for both exits; which one, only at the event
        if bool(below | early):
            if bool(early):
                buf[k] = state.resnorm
                return state, k, True, True
            stop = True
        else:
            stop = False
    else:
        stop = bool(below)
    t = time.perf_counter()
    args = _fire(method, callback, state, k + 1)
    if noted is not None and callback is not None:
        noted.append((time.perf_counter() - t, args))
    k += 1
    buf[k] = state.resnorm
    return state, k, False, stop


def _run_while(state, method: Method, *, tol, atol, maxiter, callback):
    """The host-stepped loop: one read of the stop flag a step."""

    def inner(state, k, buf, criterion):
        while True:
            state, k, early, stop = _step_once(method, method.step, state, k, buf, criterion,
                                               callback)
            if early or stop or k >= maxiter:
                return state, k, early

    return _outer(state, method, inner, tol=tol, atol=atol, maxiter=maxiter, callback=callback)


# --- the graph route -------------------------------------------------------------


def _own(state):
    """``state`` with each field in a buffer of its own (a clone)."""
    return type(state)(*(t.clone() for t in state))


def _same(a, b):
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride())


def _shares(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _assign(dst, src):
    """Copy the fields of state ``src`` into the buffers of state ``dst``
    as one parallel assignment: a field already in its buffer costs
    nothing, the others one copy each, ordered so that no copy overwrites
    a field still to be read (a cycle of buffers takes one clone)."""
    pending = [(d, s) for d, s in zip(dst, src) if not _same(d, s)]
    while pending:
        for i, (d, s) in enumerate(pending):
            if not any(_shares(d, s2) for j, (_, s2) in enumerate(pending) if j != i):
                d.copy_(s)
                del pending[i]
                break
        else:
            d, s = pending[0]
            pending[0] = (d, s.clone())


def _layout(state):
    return tuple((t.dtype, t.shape) for t in state)


def _copy_s(fields):
    return sum(COPY_LAUNCH_S + 2 * t.numel() * t.element_size() / COPY_BYTES_PER_S
               for t in fields)


def _to_ring(ring, args, k, early):
    """Copy a step's callback arguments ``args`` into slot ``k mod D`` of
    the ring ``(buffers, spare)`` (``D + 1`` slots a buffer), or into the
    spare slot ``D`` where the device bool ``early`` holds: an early success
    leaves ``k`` as it was, and step ``k``'s slot may not be fired yet."""
    buffers, spare = ring
    slot = torch.remainder(k, buffers[0].shape[0] - 1)
    if early is not None:
        slot = torch.where(early, spare, slot)
    for r, a in zip(buffers, args, strict=True):
        if (a.dtype, tuple(a.shape)) != (r.dtype, tuple(r.shape[1:])):
            raise RuntimeError(f"a callback argument changed its type or shape: "
                               f"{(r.dtype, tuple(r.shape[1:]))} -> {(a.dtype, tuple(a.shape))}")
        r.index_copy_(0, slot.reshape(1), a.unsqueeze(0))


def _graph_body(method, static, criterion, buf, k, stop, maxiter, steps, per_step,
                sites=None, tallies=None, ring=None, saved=None):
    """One replay of the graph route as ``body(guard)``: ``steps`` steps
    from the state in ``static``, each run by ``guard`` only while the
    device flag ``stop`` is down; the step that raises it, or the last
    one, copies its state back into ``static``.  When ``per_step`` is a
    list, each step's kernel launches are recorded into it, not counted,
    but for those of a counted step's conds and loops: ``sites`` takes
    them, and ``tallies`` counts their runs (:class:`._steps.DeviceStep`).
    ``ring``: a callback's ring, into which each step copies its
    ``method.callback_args`` (:func:`_to_ring`); ``saved``: a slot that
    takes history entry ``k`` before a step writes it, the recurrence value
    an early success overwrites."""
    from . import _graphs

    has_early = hasattr(static, "early_success")
    layout = _layout(static)

    def body(guard):
        def take(s):
            return method.step(s, criterion, DeviceStep(k, guard, sites, tallies))

        def guarded_step(s):
            if per_step is None:
                s2 = take(s)
            else:
                with _graphs.recording() as launches:
                    s2 = take(s)
                per_step.append(launches)
            if _layout(s2) != layout:
                raise RuntimeError(f"a step changed the state's types or shapes: {layout} "
                                   f"-> {_layout(s2)}")
            # k += 1, unless a mid-iteration exit overwrites entry k
            k.add_(~s2.early_success if has_early else 1)
            if saved is not None:
                saved.copy_(buf.index_select(0, k.reshape(1)).squeeze(0))
            buf.index_copy_(0, k.reshape(1), s2.resnorm.to(buf.dtype).unsqueeze(0))
            if ring is not None:
                _to_ring(ring, method.callback_args(s2, k), k,
                         s2.early_success if has_early else None)
            torch.logical_or(torch.all(s2.resnorm <= criterion), k >= maxiter, out=stop)
            if has_early:
                stop.logical_or_(s2.early_success)
            guard(stop, True, lambda: _assign(static, s2))
            return s2

        s = static
        for _ in range(steps):
            # once the flag is up it stays up: the later steps are skipped
            # and their (unset) states never read
            s = guard(stop, False, lambda s=s: guarded_step(s))
        guard(stop, False, lambda: _assign(static, s))

    return body


def _failing_op(exc):
    """``file:line in function: source`` of the innermost frame of ``exc``
    outside torch and this driver."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames if "/torch/" not in f.filename.replace("\\", "/")
           and not f.filename.endswith(("_driver.py", "_graphs.py"))]
    f = (own or frames)[-1] if frames else None
    return "?" if f is None else f"{f.filename}:{f.lineno} in {f.name}: {f.line}"


def _name(method):
    return getattr(method.step, "__qualname__", repr(method.step)).split(".")[0]


def _capture_failed(method, exc):
    return RuntimeError(
        f"{_name(method)}: the while_loop graph route failed to capture a step: "
        f"{_failing_op(exc)} ({type(exc).__name__}: {exc})")


class _GraphLoop:
    """The graph route's inner loop (see the module docstring): host steps
    until :func:`_plan` (or a forced plan) says to capture after a
    rehearsal step, then replays of one captured graph, whose steps' kernel
    launches it credits to the wrappers' counts as the replays run them.
    Between decisions a host step is the host-stepped loop's, nothing
    added.  ``plain``: the graph's body with each IF node's flag read on
    the host, nothing captured.  ``forced``: a plan ``(after, steps,
    replays, costs)`` of :func:`_plain_graph` or :func:`_capture_at` in
    place of the cost rule's, or ``costs`` to feed the rule.  ``kept``: the
    :class:`Kept` slot of a built solver, whose rule this loop follows and
    which may keep it after its run.  ``callback``: the solve's callback or
    :class:`ShardMonitor`, fired for every step that ran (see the module
    docstring)."""

    def __init__(self, method, maxiter, plain, forced, kept=None, callback=None):
        self.method, self.maxiter, self.plain, self.kept = method, maxiter, plain, kept
        self.callback = callback
        self.cb_times = []  # host s of the callbacks of the noted host steps
        self.ring_s, self.arg_bytes = 0.0, 0  # a step's ring copies; its arguments' bytes
        self.state_bytes = 0  # the bytes of the state's fields
        self.arg_layout = None  # the callback arguments' (dtype, shape), from the screen
        self.ring = self.spare = self.saved = None  # the ring, its spare slot; the early slot
        self.forced, self.synthetic = forced, forced[3] if forced else None
        self.fixed = forced is not None and self.synthetic is None  # a forced plan
        self.plan = None  # (U, R), once decided
        self.graph = None  # a _graphs.Captured, or the plain twin's replay
        self.per_step = None
        # a counted step's conds and loops: their launches, the runs credited
        self.sites, self.credited, self.tallies = [], [], None
        self.walls, self.launches = [], []  # host s of the steps before the last decision
        self.held_s = None  # device s of the held step, once held
        self.held_over = False  # its launches outlasted its sleep: held_s may be high
        self.copy_s = self.clone_s = 0.0  # copying the fields a step moves; all fields
        self.settled = False  # the last step kept the state's types and shapes
        self.done = False  # no decision left that could capture
        # the host step a decision follows
        self.next_check = FIRST_CHECK if kept is None else KEPT_FIRST_CHECK
        self.rehearsed = False  # the last host step was a clean rehearsal
        self.uncapturable = None  # the rehearsal's first host read
        self.unkept = None  # why a built solver may not keep this graph
        self.host_s = None  # the planned host wall a step, once captured
        self.replay_s = None  # device s a replayed step took, timed once when kept
        self.buf = self.criterion = None  # the history and criterion the graph writes
        self.left = maxiter  # the last decision's estimate of the steps left
        self.hold_k = None  # the step count once the held step has run
        self.ranks = _several(_ranks())  # a rank alone decides alone
        self.begin()

    def begin(self):
        """Start a run's bookkeeping (a kept loop's again at each run)."""
        self.info = dict(decisions=[], plan=self.plan, host_steps=0, held_steps=0, holds=[],
                         uncapturable=None, host_steps_s=0.0, decide_s=0.0, capture_s=0.0,
                         instantiate_s=0.0, replays_s=0.0, rehearse_s=0.0, screen_s=0.0,
                         roots_s=0.0, fire_s=0.0, ring_mb=self.ring_mb)
        self.t0, self.steps0 = time.perf_counter(), COUNTS["host_steps"]

    @property
    def ringed(self):
        """Whether the graph's steps copy a callback's arguments to a ring."""
        return (self.callback is not None and not isinstance(self.callback, ShardMonitor)
                and self.method.callback_args is not None)

    @property
    def ring_mb(self):
        """The ring's device MiB (0 without one)."""
        return sum(r.numel() * r.element_size() for r in self.ring or ()) / 2**20

    @property
    def monitored(self):
        """Whether the host reads the history rows for an active monitor."""
        return isinstance(self.callback, ShardMonitor) and self.callback.active

    # measurement and decision

    def _noted_step(self, state, k, buf, criterion):
        """One host step as the host-stepped loop takes it, with its host
        wall, its launches' host time, whether it kept the state's types
        and what copying its fields costs noted.  A held step
        (:meth:`_decide` asks for one) runs behind a sleep until the host
        has launched it, so that CUDA events around it time the device's
        work alone (read after its flag read, which waited for it); the
        step after a plan is the capture's rehearsal (:meth:`_rehearse`)."""
        hold = self.hold_k == k + 1
        rehearse = self.plan is not None
        t_launch, t_slept = [], []
        events = None
        if hold and not self.plain:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            sleep = int(HOLD_CYCLES_PER_S * _sleep_s(self._costs(self.left))
                        * 2 ** len(self.info["holds"]))  # doubled after each dropped one

        def step(s, crit, ctl):
            if events is not None:
                torch.cuda._sleep(sleep)
                t_slept.append(time.perf_counter())
                events[0].record()
            s2 = self.method.step(s, crit, ctl)
            t_launch.append(time.perf_counter())
            if events is not None:
                events[1].record()
            return s2

        if rehearse:
            step = functools.partial(self._rehearse, step)
        noted = []
        t0 = time.perf_counter()
        new, k2, early, stop = _step_once(self.method, step, state, k, buf, criterion,
                                          self.callback, noted)
        t1 = time.perf_counter()
        fired, args = noted[0] if noted else (0.0, None)
        if noted:
            self.cb_times.append(fired)
        if args is not None:
            args = [a for a in args if isinstance(a, torch.Tensor)]
            self.ring_s = 2 * _copy_s(args)  # into the ring, and a clone out of it
            self.arg_bytes = sum(a.numel() * a.element_size() for a in args)
        if not (rehearse or hold):
            self.walls.append(t1 - t0 - fired)
            self.launches.append(t_launch[0] - t0)
        self.settled = _layout(new) == _layout(state)
        self.copy_s = _copy_s(a for a, b in zip(new, state) if a.data_ptr() != b.data_ptr())
        self.clone_s = _copy_s(new)
        self.state_bytes = sum(t.numel() * t.element_size() for t in new)
        if hold:
            COUNTS["held_steps"] += 1
            self.info["held_steps"] += 1
            if events is None:
                self.held_s = self.synthetic(self.left).device_s
            else:
                self.held_s = events[0].elapsed_time(events[1]) * 1e-3
                # the device ran the step alone only if the host launched it
                # all before the sleep ended
                window, slept = t_launch[0] - t_slept[0], sleep / HOLD_CYCLES_PER_S
                self.held_over = window > slept
                self.info["holds"].append((window, slept, self.held_s))
        return new, k2, early, stop

    def _costs(self, steps_left):
        """The :class:`Costs` of a decision: measured, or the synthetic ones
        fed to the rule; the device time 0 until a step has been held."""
        if self.synthetic is not None:
            c = self.synthetic(steps_left)
        else:
            c = Costs(steps_left, min(self.walls[-2:]), _median(self.launches[-2:]), 0.0,
                      self.copy_s, self.clone_s, self.method.even_steps, self.ring_s,
                      _median(self.cb_times[-2:]) if self.cb_times else 0.0, self.arg_bytes,
                      self.state_bytes)
        return c._replace(device_s=0.0 if self.held_s is None else self.held_s)

    def _decide(self, k, buf, criterion):
        """The plan to capture now, or None."""
        if self.fixed:
            after, steps, replays, _ = self.forced
            return (steps, replays) if k + 1 >= after and self.settled else None
        if not self.settled or (self.synthetic is None and not self.walls):
            self.next_check = k + 1  # the state's types still change: decide after the next
            return None
        if self.hold_k == k:
            self.left -= 1  # the decision before the held step read the history
        else:
            n = buf[0].numel()
            # one copy to the host: the history so far and the criterion
            ends = torch.cat((buf[: k + 1].reshape(-1), criterion.reshape(-1)))
            ends = (ends.float() if ends.dtype == torch.bfloat16 else ends).tolist()
            cols = [ends[i: n * (k + 1): n] for i in range(n)]
            crit = ends[n * (k + 1):]
            self.left = _steps_left(cols, crit * (n // len(crit)), self.maxiter - k)
        costs, over = self._agreed(self._costs(self.left))
        self.left = costs.steps_left
        if self.kept is not None:
            # this run's steps left and one more run's (KEPT_FIRST_CHECK)
            costs = costs._replace(steps_left=2 * costs.steps_left + k)
        plan = _plan(costs)
        if plan is None and over and self.info["held_steps"] < HOLD_TRIES:
            # a hold that may have timed the device's waits refused the plan:
            # the next step is held again
            self.held_s, self.held_over = None, False
            costs = costs._replace(device_s=0.0)
            plan = _plan(costs)
        self.walls, self.launches = self.walls[-2:], self.launches[-2:]
        self.cb_times = self.cb_times[-2:]
        self.info["decisions"].append((k, costs, plan))
        if plan is not None and self.held_s is None:
            # a capture would repay if the device took no time: hold the next
            # step to see its device time, if that costs little enough
            if (self.kept is not None or _sleep_s(costs) <= MEASURE_SHARE * costs.steps_left
                    * (costs.host_s + costs.callback_s)):
                self.hold_k = self.next_check = k + 1
                return None
            plan = None
        elif plan is None and (self.kept is not None or _plan(
                costs._replace(steps_left=self.maxiter - k)) is None):
            # not even every step to maxiter repays it (a built solver: not
            # this run and the next): no later decision would capture, so
            # the rest of the solve is the host loop's, and every later run
            # of a built solver too
            self.done = True
            if self.kept is not None:
                self.kept.host = True
        # decide again when the step count has doubled, or when the
        # estimate says the solve should have ended
        if plan is None:
            self.next_check = max(2 * k, k + costs.steps_left)
        else:
            self.host_s = costs.host_s
        return plan

    # the ranks of a sharded solve (see _sharded)

    def _meet(self, values):
        """The largest of each of ``values`` over the solve's ranks: one
        small collective and one host read (on a rank alone, the values)."""
        return _meet(self.ranks, values)

    def _agreed(self, c):
        """``(costs, over)``: the :class:`Costs` ``c`` with the steps left
        and each time the largest over the solve's ranks, and whether any
        rank's hold outlasted its sleep, so that every rank plans alike (the
        state's bytes the least over the ranks)."""
        if self.ranks is None:
            return c, self.held_over
        left, *times, ring_s, callback_s, arg_bytes, state_bytes, over = self._meet(
            [*c[:6], c.ring_s, c.callback_s, c.arg_bytes, -c.state_bytes,
             float(self.held_over)])
        return Costs(int(left), *times, c.even, ring_s, callback_s, int(arg_bytes),
                     -int(state_bytes)), bool(over)

    def _agree(self, failed, uncapturable=None, unkept=None):
        """After a rehearsal or a capture: raise on every rank when any
        rank's failed (``failed`` on that rank, an error naming it on the
        others), so that no rank replays alone; note a host read of any
        rank's rehearsal in ``self.uncapturable``, and a read that keeps
        any rank from keeping its graph in ``self.unkept``."""
        me = self.ranks.index + 1 if self.ranks is not None else 1
        f, u, n = self._meet([me if failed is not None else 0, me if uncapturable else 0,
                              me if unkept else 0])
        self.unkept = self.unkept or unkept or (
            f"a read on rank {self.ranks.ranks[int(n) - 1]}" if n else None)
        if failed is not None:
            raise failed
        if f:
            raise RuntimeError(
                f"{_name(self.method)}: rank {self.ranks.ranks[int(f) - 1]} of this sharded "
                "solve failed to capture a step, so no rank replays its graph")
        self.uncapturable = uncapturable or (
            f"a host read on rank {self.ranks.ranks[int(u) - 1]}" if u else None)

    def _measures(self, k):
        """Whether host step ``k + 1`` is noted: a step of the two before a
        decision, a held step, the rehearsal, every step of a forced plan."""
        return (self.fixed or self.hold_k == k + 1 or self.plan is not None
                or (not self.done and self.next_check - 2 <= k < self.next_check))

    # capture and replays

    def _rehearse(self, step, state, criterion, ctl):
        """``step(state, criterion, ctl)`` as the capture's rehearsal, after
        a screen of the step's device form: on the stream the graph's steps
        are captured on (a kernel module, a cuBLAS workspace of that stream
        are made here, outside any capture), ``ensure_real`` reading nothing
        on the host, and each operation that a graph could not replay
        noted; the first one, if any, in ``self.uncapturable``.

        The screen runs the form the capture records (:class:`DeviceStep`
        on a device counter at ``ctl.k``) once on a clone of ``state``
        taken before the step, each IF and WHILE body once
        (:data:`._graphs.ONCE`: what a conditional body holds is screened
        whether or not this step would run it), its launches not counted,
        its collectives not launched (:func:`._graphs.dry`) and its results
        dropped but for the layout of the callback arguments a ring takes
        (``method.callback_args`` in its device form, screened too; the
        user's callback is not called).  An exception there raises as a
        failed capture would, on every rank of a sharded solve, which then
        agree (:meth:`_agree`)."""
        from . import _graphs
        from ._inner import host_checks_off

        dev = state.resnorm.device
        probe = _own(state)
        reads = set()

        def screen():
            with _graphs.recording(), _graphs.dry(), (
                    _graphs.storages_read(reads) if self.kept is not None
                    else contextlib.nullcontext()):
                k = torch.full((), ctl.k, dtype=torch.int64, device=dev)
                out = self.method.step(probe, criterion, DeviceStep(k, _graphs.ONCE))
                if self.ringed:
                    args = self.method.callback_args(out, k + 1)
                    bad = [type(a).__name__ for a in args if not isinstance(a, torch.Tensor)]
                    if bad:
                        raise TypeError(f"a callback argument is a {bad[0]}, not a tensor")
                    self.arg_layout = [(a.dtype, tuple(a.shape)) for a in args]

        failed = None
        t0 = time.perf_counter()
        with host_checks_off(), _graphs.host_reads(dev.type) as seen:
            if self.plain:
                out = step(state, criterion, ctl)
            else:
                out = _graphs.on_body_stream(lambda: step(state, criterion, ctl), dev)
            t1 = time.perf_counter()
            try:
                if self.plain:
                    screen()
                else:
                    _graphs.on_body_stream(screen, dev)
            except Exception as exc:  # noqa: BLE001 - raised again, naming the step
                failed = _capture_failed(self.method, exc)
                failed.__cause__ = exc
        t2 = time.perf_counter()
        unkept = None
        if self.kept is not None and failed is None:
            unkept = self._foreign(reads, (*probe, criterion))
        self.info.update(rehearse_s=t1 - t0, screen_s=t2 - t1,
                         roots_s=time.perf_counter() - t2)
        self._agree(failed, seen[0] if seen else None, unkept)
        return out

    def _foreign(self, reads, own):
        """Why the graph of a built solver may not be kept: the first
        tensor the screen read (``reads``: storage, dtype, shape) that is
        not ``own`` (the probe state, the criterion) nor reached from the
        built solver's own objects, a tensor made for one solve that a
        later run's replay would read again; None if there is none."""
        from ._graphs import reachable_storages

        mine = {t.untyped_storage().data_ptr() for t in own if t is not None}
        built = reachable_storages(self.kept.roots)
        for ptr, dtype, shape in sorted(reads, key=str):
            if ptr not in mine and ptr not in built:
                return (f"{_name(self.method)}: its step reads a {dtype} tensor of shape "
                        f"{shape} made for one solve, outside its state")
        return None

    def _capture(self, state, k, buf, criterion):
        """The graph of this solve, on buffers of the driver's own, one a
        field of ``state``: returns that state."""
        dev = state.resnorm.device
        steps = self.plan[0]
        self.static = _own(state)
        self.buf, self.criterion = buf, criterion
        self.k_dev = torch.full((), k, dtype=torch.int64, device=dev)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        ring = None
        if self.ringed:
            # two batches of a read's steps, and the spare slot
            D = 2 * steps * self.plan[1]
            self.ring = [torch.empty((D + 1,) + shape, dtype=dtype, device=dev)
                         for dtype, shape in self.arg_layout]
            self.spare = torch.full((), D, dtype=torch.int64, device=dev)
            ring = (self.ring, self.spare)
            self.info["ring_mb"] = self.ring_mb
        if self.monitored and hasattr(state, "early_success"):
            self.saved = torch.zeros_like(buf[0])
        from . import _graphs

        if self.plain:
            body = _graph_body(self.method, self.static, criterion, buf, self.k_dev, self.stop,
                               self.maxiter, steps, None, ring=ring, saved=self.saved)
            self.graph = lambda: body(_graphs.PLAIN)
            COUNTS["captures"] += 1
            return self.static
        per_step = []
        self.tallies = torch.zeros(_steps.MAX_SITES, dtype=torch.int64, device=dev)
        body = _graph_body(self.method, self.static, criterion, buf, self.k_dev, self.stop,
                           self.maxiter, steps, per_step, self.sites, self.tallies, ring,
                           self.saved)
        t0 = time.perf_counter()
        try:
            # a process group's watchdog thread queries the events of its
            # collectives while this thread captures
            self.graph = _graphs.capture(body, dev, "global" if self.ranks is None
                                         else "thread_local", own_pool=self.kept is not None)
        except Exception as exc:  # noqa: BLE001 - raised again, naming the step
            raise _capture_failed(self.method, exc) from exc
        self.per_step = per_step
        COUNTS["captures"] += 1
        inst = _graphs.LAST["instantiate_s"]
        self.info.update(capture_s=time.perf_counter() - t0 - inst, instantiate_s=inst)
        return self.static

    def _sites_ran(self, tallies):
        """Credit the runs of each counted site since the last call, from
        its device tally (read with the step counter)."""
        from ._graphs import credit

        for i, (launches, n) in enumerate(zip(self.sites, tallies)):
            if i == len(self.credited):
                self.credited.append(0)
            credit(launches, n - self.credited[i])
            self.credited[i] = n

    def _ran(self, n):
        """Credit ``n`` steps that replays ran, from a replay's first."""
        COUNTS["graph_steps"] += n
        if self.per_step:
            from ._graphs import credit

            full, rest = divmod(n, len(self.per_step))
            for i, launches in enumerate(self.per_step):
                credit(launches, full + (i < rest))

    def __call__(self, state, k, buf, criterion):
        while self.graph is None:
            if self.plan is None and not self.done and (k == self.next_check or self.fixed):
                t0 = time.perf_counter()
                self.plan = self._decide(k, buf, criterion)
                self.info["decide_s"] += time.perf_counter() - t0
            if self.rehearsed:
                self.info["plan"] = self.plan
                self._host_part()
                failed = None
                try:
                    state = self._capture(state, k, buf, criterion)
                except Exception as exc:  # noqa: BLE001 - raised on every rank, below
                    failed = exc
                self._agree(failed)
                break
            if not self._measures(k):  # the host-stepped loop's step
                state, k, early, stop = _step_once(self.method, self.method.step, state, k,
                                                   buf, criterion, self.callback)
            else:
                rehearse = self.plan is not None
                state, k, early, stop = self._noted_step(state, k, buf, criterion)
                if rehearse and self.uncapturable is not None:
                    # a step that reads the host: this solve stays on the host
                    # loop, decided before any capture
                    COUNTS["uncapturable"] += 1
                    self.info["uncapturable"] = self.uncapturable
                    self.plan, self.done = None, True
                self.rehearsed = rehearse and not self.done
            if early or stop or k >= self.maxiter:
                return state, k, early
        steps, per_read = self.plan
        replay = self.graph if self.plain else self.graph.replay
        if state is not self.static:
            # a kept graph's next run: its initial state into the static
            # buffers, the device counter to its step
            _assign(self.static, state)
            self.k_dev.fill_(k)
        self.stop.fill_(False)
        # a built solver's capturing run times its first replays once,
        # where the rule planned them
        timing = (self.kept is not None and not self.plain and self.replay_s is None
                  and self.host_s is not None)
        t0 = time.perf_counter()
        pending = None  # the callbacks of the last batch of replays, still to fire
        while True:
            n = min(per_read, -(-(self.maxiter - k) // steps))
            events = timing and [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            if events:
                events[0].record()
            try:
                for _ in range(n):
                    replay()
            except Exception as exc:  # noqa: BLE001 - raised again, naming the solver
                raise RuntimeError(f"{_name(self.method)}: a replay of the while_loop graph "
                                   f"failed ({type(exc).__name__}: {exc})") from exc
            if events:
                events[1].record()
            if pending is not None:
                self._fire(*pending)  # while this batch replays
            COUNTS["replays"] += n
            COUNTS["flag_reads"] += 1
            stopped, rows, saved = self._read(k, n * steps)
            if events:
                timing = False
                ran = (int(self.k_dev) - k) if stopped else n * steps
                self._timed(events[0].elapsed_time(events[1]) * 1e-3, max(ran, 1))
            if stopped:
                break
            pending = (k, k + n * steps, rows)
            self._ran(n * steps)  # no step raised the flag: all of them ran
            k += n * steps
        if self.sites:
            k_end, *tallies = torch.cat((self.k_dev.reshape(1),
                                         self.tallies[: len(self.sites)])).tolist()
            self._sites_ran(tallies)
        else:
            k_end = int(self.k_dev)
        early = hasattr(self.static, "early_success") and bool(self.static.early_success)
        self._ran(k_end - k + early)  # an early exit's step leaves k as it was
        if early and rows is not None and k_end > k:
            # step k_end's recurrence value, which the early step overwrote
            rows[k_end - k - 1] = saved
        self._fire(k, k_end, rows)
        self.info["replays_s"] += time.perf_counter() - t0
        return self.static, k_end, early

    def _read(self, k, m):
        """``(stopped, rows, saved)``: the stop flag after replays from step
        ``k`` of at most ``m`` steps; for an active :class:`ShardMonitor`,
        in the same copy to the host, the history rows of those steps (a
        host array a step) and the early success's slot, else None."""
        if not self.monitored:
            return bool(self.stop), None, None
        hi = min(k + m, self.maxiter)
        shape = tuple(self.buf.shape[1:])
        parts = [self.stop.reshape(1).to(self.buf.dtype), self.buf[k + 1: hi + 1].reshape(-1)]
        if self.saved is not None:
            parts.append(self.saved.reshape(-1))
        host = _history(torch.cat(parts))
        n = (hi - k) * int(np.prod(shape, dtype=np.int64))
        rows = list(host[1: 1 + n].reshape((hi - k,) + shape))
        saved = host[1 + n:].reshape(shape) if self.saved is not None else None
        return bool(host[0]), rows, saved

    def _fire(self, first, last, rows):
        """The callbacks of steps ``first + 1 .. last``, which replays ran:
        a monitor's from ``rows`` (:meth:`_read`), a callback's on clones of
        its ring slots (no later replay writes them)."""
        if last <= first or self.callback is None:
            return
        t0 = time.perf_counter()
        if rows is not None:
            for j in range(first + 1, last + 1):
                self.callback.fn(j, np.array(rows[j - first - 1]))
        elif self.ring is not None:
            D = self.ring[0].shape[0] - 1
            for j in range(first + 1, last + 1):
                self.callback(*(r[j % D].clone() for r in self.ring))
        self.info["fire_s"] += time.perf_counter() - t0

    def _timed(self, seconds, steps):
        """The device time of a built solver's first replays, ``steps`` of
        them, the largest over its ranks: a replayed step dearer than the
        planned host-stepped step's wall keeps the solver host-stepped for
        every later run."""
        (self.replay_s,) = self._meet([seconds / steps])
        if self.replay_s >= self.host_s:
            self.kept.host = True

    def _host_part(self):
        """Note the steps from the host so far and their host seconds."""
        self.info.update(host_steps=COUNTS["host_steps"] - self.steps0, host_steps_s=(
            time.perf_counter() - self.t0 - self.info["decide_s"]))

    def release(self):
        """Drop the graph and give back its pool: the solve's results live
        in the driver's buffers, outside it."""
        if self.graph is not None and not self.plain:
            self.graph.release()
        self.graph = self.ring = self.spare = self.saved = None


def _median(xs):
    """The median of a short list of floats (``np.median`` costs a
    millisecond a call on a list)."""
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def _run_graph(state0, method: Method, *, tol, atol, maxiter, callback=None, plain=False,
               plan=None):
    t0 = time.perf_counter()
    slot = _slot()
    if slot is not None:
        return _run_kept(slot, state0, method, t0, tol=tol, atol=atol, maxiter=maxiter,
                         callback=callback, plain=plain, plan=plan)
    COUNTS["graph_route"] += 1
    loop = _GraphLoop(method, maxiter, plain, plan, callback=callback)
    try:
        return _outer(state0, method, loop, tol=tol, atol=atol, maxiter=maxiter,
                      callback=callback)
    finally:
        if loop.graph is None:
            loop._host_part()
        loop.release()
        LAST_GRAPH.clear()
        LAST_GRAPH.update(loop.info, total_s=time.perf_counter() - t0)


def _run_kept(slot, state0, method, t0, *, tol, atol, maxiter, callback, plain, plan):
    """A run of a built solver on the graph route: the kept graph replayed
    from step 0 when its key holds on every rank, the host-stepped loop
    when the rule keeps the solver there, else a run that may capture a
    graph to keep (see the module docstring)."""
    key = _key(method, state0, maxiter, plain, plan, callback)
    ranks = _several(_ranks())
    if slot.key is not None and _meet(ranks, [float(slot.key != key)])[0]:
        slot.release()  # a key that differs on any rank: every rank starts anew
    if slot.key is not None and slot.host:
        COUNTS["host_stepped"] += 1
        out = _run_while(state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback)
        LAST_GRAPH.clear()
        LAST_GRAPH.update(kept="host", unkept=slot.why, total_s=time.perf_counter() - t0)
        return out
    loop, rerun = slot.loop, slot.loop is not None
    if rerun:
        # its hooks and callback; the graph replays the first run's step
        loop.method, loop.callback = method, callback
        loop.begin()
        COUNTS["kept_runs"] += 1
    else:
        loop = _GraphLoop(method, maxiter, plain, plan, kept=slot, callback=callback)
    COUNTS["graph_route"] += 1
    keep = False
    try:
        state, ok, k, hist = _outer(state0, method, loop, tol=tol, atol=atol, maxiter=maxiter,
                                    callback=callback,
                                    kept=(loop.buf, loop.criterion) if rerun else None)
        keep = loop.graph is not None and loop.unkept is None and not slot.host
        if keep and any(_shares(a, b) for a, b in zip(state, loop.static)):
            state = _own(state)  # the next run overwrites the kept buffers
        return state, ok, k, hist
    finally:
        if loop.graph is None:
            loop._host_part()
        if keep:
            slot.loop, slot.key, slot.why = loop, key, None
        else:
            loop.release()
            slot.loop = None
            slot.why = loop.unkept
            # a decision the rule took for every run holds for this key
            slot.key = key if slot.host else None
        LAST_GRAPH.clear()
        LAST_GRAPH.update(loop.info, kept=(
            "replayed" if rerun and keep else "captured" if keep
            else "host" if slot.host else None), unkept=loop.unkept,
            replay_step_s=loop.replay_s, total_s=time.perf_counter() - t0)
