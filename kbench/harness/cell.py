"""One run of one cell: set-up, the closed loop's window, the traced
sub-window, the check against the reference, and the result line.

The loop is closed: one caller sends the next solve when the last one has
returned.  Each call's right-hand side is ``b = A x*``, ``x*`` drawn on the
device from ``--seed`` and the call's number and ``A`` the reference
stencil, so the same seed gives the same inputs and the port receives only
``A``, ``b`` and its arguments.
"""

import gc
import random
import sys
import time
from typing import NamedTuple

import torch

from . import check, spec, trace

# top-level module names that must not be loaded in the measured process
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "krylov_tpu"})
WARMUP_CALLS = 2
TRACE_MIN_S, TRACE_MIN_CALLS = 1.0, 2


class Call(NamedTuple):
    ms: float  # from the call to its synchronised return
    rhs: int  # right-hand sides solved by the call
    steps: int  # the solver's numsteps
    ok: bool  # converged where a tolerance stops it; a finite history otherwise
    counts: dict  # the port's counters' increase over the call


class Run(NamedTuple):
    """What a metric reader reads."""

    wl: dict
    cfg: dict
    card: str
    n: int  # unknowns of one right-hand side
    itemsize: int
    setup_s: float
    window_s: float
    calls: list  # Call, one a solve of the window
    trace: object  # trace.Trace of the traced sub-window, or None


class Info(NamedTuple):
    """A solve's result in the fields the harness reads of the port's."""

    success: bool
    xk: torch.Tensor
    numsteps: int
    resnorms: object


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the measured process."""


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def call_seed(seed, i):
    """The generator seed of call ``i`` (warm-up calls are negative)."""
    return (int(seed) % (1 << 62) * 1000003 + int(i) + 4096) % (1 << 63)


class Rhs:
    """``make(i)``: call ``i``'s flat right-hand side ``A x*``."""

    def __init__(self, A_ref, k, seed, dtype, device):
        self.A, self.k, self.seed, self.dtype = A_ref, int(k), seed, dtype
        self.shape = tuple(A_ref.grid) + ((self.k,) if self.k > 1 else ())
        self.gen = torch.Generator(device=device)
        self.device = device

    def xstar(self, i):
        self.gen.manual_seed(call_seed(self.seed, i))
        return torch.randn(self.shape, generator=self.gen, dtype=self.dtype,
                           device=self.device)

    def make(self, i):
        b = self.A @ self.xstar(i)
        return b.reshape((self.A.n,) + ((self.k,) if self.k > 1 else ()))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters():
    """The port's counters of its solve loop's routes and steps (``_driver.COUNTS``)."""
    from krylov_tpu_torch import _driver

    return {f"driver.{k}": v for k, v in _driver.COUNTS.items()}


def _ok(info, stops):
    if stops:
        return bool(info.success)
    return bool(torch.isfinite(torch.as_tensor(info.resnorms)).all())


def closed_loop(call, rhs, device, seconds, stops, samples, seed):
    """Calls from number 0 on until ``seconds`` have passed:
    ``(calls, kept, window_s)``, ``kept`` a sample of ``(i, info)`` drawn
    from ``seed`` over every call (reservoir sampling)."""
    pick = random.Random(seed)
    calls, kept = [], []
    i = 0
    t_begin = time.perf_counter()
    while True:
        b = rhs.make(i)
        sync(device)
        c0 = counters()
        t0 = time.perf_counter()
        info = call(b)
        sync(device)
        t1 = time.perf_counter()
        c1 = counters()
        del b
        calls.append(Call((t1 - t0) * 1e3, rhs.k, int(info.numsteps), _ok(info, stops),
                          {k: c1[k] - c0[k] for k in c1}))
        slot = i if i < samples else pick.randrange(i + 1)
        if slot < samples:
            entry = (i, info._replace(xk=info.xk.clone()))
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        del info
        i += 1
        if t1 - t_begin >= seconds:
            return calls, kept, t1 - t_begin


def traced(call, rhs, device, first):
    """Profile calls from number ``first`` for at least ``TRACE_MIN_S``
    seconds and ``TRACE_MIN_CALLS`` calls: a :class:`trace.Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    n = 0
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            while n < TRACE_MIN_CALLS or time.perf_counter() - t0 < TRACE_MIN_S:
                b = rhs.make(first + n)
                with record_function("kbench.solve"):
                    call(b)
                sync(device)
                n += 1
    return trace.reduce(prof.events())


class Spanned:
    """The preconditioner ``M`` with each application inside a profiler
    span (``kbench.precond``), for the traced sub-window only."""

    def __init__(self, M):
        self.M = M
        self.shape, self.dtype = M.shape, M.dtype
        self.hermitian = getattr(M, "hermitian", False)

    def __matmul__(self, r):
        from torch.profiler import record_function

        with record_function("kbench.precond"):
            return self.M @ r

    matvec = __matmul__

    def rmatvec(self, x):
        return self.M.rmatvec(x)


def build(kt, wl, cfg, dtype, device, program, spanned=False):
    """``call(b) -> info`` of the port (``program="port"``) or of the
    control, the reference in the precision below the configuration's
    (``program="control"``).  ``spanned``: each preconditioner application
    inside a profiler span, for the traced sub-window."""
    op = spec.part(cfg["operator"])
    if program == "control":
        pre = wl.get("precond")
        low = spec.LOWER[dtype]
        A_lo = op.reference(cfg, low, device)
        M_lo = None if pre is None else spec.part(pre["kind"]).reference(A_lo, pre["args"])
        solve = check.reference_solver(A_lo, M_lo, wl)

        def control(b):
            r = solve(check.grid_view(b, A_lo.grid))
            return Info(r.success, r.x.to(dtype).reshape(b.shape), r.numsteps, r.resnorms)

        return control
    A = op.port(kt, cfg, dtype, device)
    return spec.part(wl["entry"]).port(kt, A, wl, Spanned if spanned else None)


def run_cell(cell, seed, seconds, traced_run, device, t_start, root=spec.KBENCH,
             program="port"):
    """The result line's fields: ``checks``, last, holds each number compared
    beside its limit, ``readings`` the numbers the cell does not compare."""
    import krylov_tpu_torch as kt

    wl = spec.workload(cell, root)
    cfg = spec.config(wl["config"], root)
    dtype = spec.DTYPES[cfg["dtype"]]
    stops = wl["tol"] > 0 or wl["atol"] > 0
    A_ref = spec.part(cfg["operator"]).reference(cfg, dtype, device)
    rhs = Rhs(A_ref, wl["rhs"], seed, dtype, device)

    call = build(kt, wl, cfg, dtype, device, program)
    for i in range(1, WARMUP_CALLS + 1):
        call(rhs.make(-i))
    sync(device)
    setup_s = time.perf_counter() - t_start

    calls, kept, window_s = closed_loop(call, rhs, device, seconds, stops,
                                        wl["samples"], seed)
    tr = None
    if traced_run:
        spanned = build(kt, wl, cfg, dtype, device, program, spanned=True)
        tr = traced(spanned, rhs, device, len(calls))
        del spanned
    found = loaded_forbidden()
    if found:
        raise ForbiddenModules(found)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    pre = wl.get("precond")
    A64 = spec.part(cfg["operator"]).reference(cfg, torch.float64, device)
    M_ref = None if pre is None else spec.part(pre["kind"]).reference(A_ref, pre["args"])
    values = check.numbers(kept, rhs, A64, check.reference_solver(A_ref, M_ref, wl), wl)
    correct, checks = check.verdict(values, wl["limits"])

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(wl, cfg, card, A_ref.n, dtype.itemsize, setup_s, window_s, calls, tr)
    bench = spec.benchmark()
    section = "per_layer" if traced_run else "end_to_end"
    metrics = {}
    for m in spec.metrics(bench, cell, section):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(calls),
            "failed": sum(1 for c in calls if not c.ok), "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": trace.top({k: v[0] for k, v in tr.kernels.items()}),
                             "idle_gaps": trace.top(tr.gaps)}
    found = loaded_forbidden()
    if found:
        raise ForbiddenModules(found)
    line["readings"] = {k: v for k, v in values.items() if k not in checks}
    line["checks"] = checks
    return line
