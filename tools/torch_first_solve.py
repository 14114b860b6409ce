#!/usr/bin/env python3
"""A process's first ``while_loop`` solve, host-stepped and on the graph
route, each in a fresh interpreter (krylov_tpu_torch).

Run from the root of the repository on a machine with one CUDA device:

    python3 tools/torch_first_solve.py [--other DIR] [--processes 3] [--trace]

Cells (``--cells``), set up and timed by ``chip_smoke.py``'s
``first_solve_cells`` and ``first_solves``: ``cg_jacobi``, phase 13's
``cg`` + Jacobi on the unshifted 1M-row CSR (K10), 1500 steps;
``chebyshev``, phase 13's 1000 steps on ``poisson_2d_const(1024)`` (K2);
``built_mgcg`` and ``built_amg``, the first run of phase 14's MG-CG on
``poisson_2d_const(4096)`` and ``cg`` + ``partition_amg`` built solvers
(``parallel.make_sharded_solver`` on one NCCL rank).  Routes: ``host``
(``_driver._host_stepped()``) and ``rule`` (the cost rule's graph route).
Each route of a cell runs in ``--processes`` new interpreters, the
routes alternating, and, with ``--other DIR`` (another checkout's root,
e.g. an unpacked ``git archive`` of the parent commit), the same with
that checkout's package, in turn.  Each process imports the package
(timed), sets up its cell, then times its first solve (split into the
host steps, of which the rehearsal step, the screen and a built solver's
walk of its own objects, the decisions, the capture, its instantiation
and the replays, as ``_driver.LAST_GRAPH`` gives them) and a second solve,
and counts the modules the first solve imported, naming
``torch._dynamo``, ``torch._inductor``, ``sympy`` and ``triton`` among
them.  Prints one JSON line a process (with the rule's decisions, each
held step's host launch window, sleep and device seconds, and the card's
SM clock and power before the first solve and after the second), then for
each cell, route and checkout the median and spread (largest less
smallest) of each.

``--trace``: one more process a cell on the rule route under
``krylov_tpu_torch.profiling.trace`` (a ``torch.profiler`` trace in
``--out``, default ``first_solve_out/``; its events summed by name, the
largest printed, the trace removed) and one under ``cProfile`` (the
Python functions of largest cumulative time, kept in ``--out``), for each
checkout.

``--device cpu --small`` rehearses the tool on the CPU (the route's plain
twin, ``_driver._plain_graph(3, 4, 8)``, in place of the rule; small
sizes).  ``--child CELL ROUTE`` is one process (what the others spawn).
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "first_solve_out")  # --out's default


def child(cell, route, args):
    """One fresh process: import, set up, two timed solves; one JSON line."""
    t0 = time.perf_counter()
    import torch

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _driver

    import_s = time.perf_counter() - t0
    cm = smoke()
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        kt.set_default_device("cpu")
    t0 = time.perf_counter()
    solves = cm.first_solve_cells(cell, dev, args.small)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    clocks = [gpu_clocks(dev)]
    got = cm.first_solves(solves, route, dev, first=lambda: profiled(args, cell, route, _driver))
    clocks.append(gpu_clocks(dev))
    print(json.dumps(dict(label=args.label, cell=cell, route=route, import_s=import_s,
                          setup_s=setup_s, **got, clocks=clocks, profile=args.profile)),
          flush=True)


def smoke():
    """This checkout's ``chip_smoke.py``, whichever checkout's package the
    process imports (``--other``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    return cm


@contextlib.contextmanager
def profiled(args, cell, route, _driver):
    """Within: the ``--profile`` of the first solve, if any: a
    ``torch.profiler`` trace in ``--out`` with the loop's parts marked
    (:func:`annotated`), or a cProfile printed to the standard error."""
    if args.profile == "torch":
        from krylov_tpu_torch import profiling

        with profiling.trace(os.path.join(args.out, f"{args.label}_{cell}_{route}")), \
                annotated(_driver):
            yield
    elif args.profile == "python":
        import cProfile
        import io
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        try:
            yield
        finally:
            pr.disable()
        text = io.StringIO()
        pstats.Stats(pr, stream=text).sort_stats("cumulative").print_stats(45)
        print(text.getvalue(), file=sys.stderr)
    else:
        yield


# the graph route's parts a profiled process marks in its trace
MARKED = {"_decide": "decide", "_rehearse": "rehearse", "_foreign": "roots",
          "_capture": "capture"}


def annotated(_driver):
    """Within: each part of :data:`MARKED` of the driver's graph loop, and
    each CUDA graph's instantiation, is a ``record_function`` range named
    ``first_solve.<part>`` (the trace's events are summed by part)."""
    import functools
    from unittest import mock

    import torch

    def marked(fn, name):
        @functools.wraps(fn)
        def run(*a, **kw):
            with torch.profiler.record_function(f"first_solve.{name}"):
                return fn(*a, **kw)
        return run

    stack = contextlib.ExitStack()
    for attr, name in MARKED.items():
        stack.enter_context(mock.patch.object(
            _driver._GraphLoop, attr, marked(getattr(_driver._GraphLoop, attr), name)))
    stack.enter_context(mock.patch.object(
        torch.cuda.CUDAGraph, "instantiate",
        marked(torch.cuda.CUDAGraph.instantiate, "instantiate")))
    return stack


def gpu_clocks(dev):
    """The card's SM clock and power draw now (``nvidia-smi``), or None."""
    if dev.type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def spawn(root, label, cell, route, args, profile=None):
    """One child process over the package at ``root``; its JSON line."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", cell, route, "--label", label,
           "--device", args.device] + (["--small"] if args.small else []) + (
        ["--profile", profile, "--out", args.out] if profile else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, ROOT]))
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                          timeout=args.timeout)
    if proc.returncode != 0:
        raise SystemExit(f"{label} {cell} {route}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line), proc.stderr


def trace_summary(logdir, top=20):
    """The trace's host operations and CUDA runtime calls of each name
    summed, ``(ms, count, name)``, the ``top`` largest: of the whole solve
    (key ``"all"``) and of each part the process marked (:func:`annotated`;
    the events that lie within its ranges on its thread).  The trace files
    are removed: a solve's trace runs to tens of MB."""
    events = []
    for name in os.listdir(logdir):
        if name.endswith(".json"):
            with open(os.path.join(logdir, name)) as f:
                events += [e for e in json.load(f).get("traceEvents", [])
                           if e.get("ph") == "X" and "dur" in e]
            os.remove(os.path.join(logdir, name))
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("first_solve.")]
    parts = {"all": lambda e: True}
    for m in marks:
        part = m["name"].split(".", 1)[1]
        inside = parts.get(part, lambda e: False)
        parts[part] = (lambda e, m=m, inside=inside: inside(e) or (
            e.get("tid") == m.get("tid") and m["ts"] <= e["ts"] <= m["ts"] + m["dur"]))
    out = {}
    for part, within in parts.items():
        totals = {}
        for e in events:
            if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver") and within(e):
                ms, n = totals.get(e["name"], (0.0, 0))
                totals[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
        mark_ms = sum(m["dur"] / 1e3 for m in marks if m["name"] == f"first_solve.{part}")
        out[part] = (mark_ms, sorted(((ms, n, k) for k, (ms, n) in totals.items()),
                                     reverse=True)[:top])
    return out


def median_spread(xs):
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None, None
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2]), xs[-1] - xs[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="cg_jacobi,chebyshev,built_mgcg",
                    help="comma-separated, of cg_jacobi, chebyshev, built_mgcg, built_amg")
    ap.add_argument("--processes", type=int, default=3, help="fresh processes a route")
    ap.add_argument("--other", default=None, help="another checkout's root, run in turn")
    ap.add_argument("--trace", action="store_true", help="profiled processes, see above")
    ap.add_argument("--trace-cells", default="cg_jacobi,built_mgcg,built_amg")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="rehearsal sizes")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a process")
    ap.add_argument("--out", default=OUT, help="where traces and profiles go")
    ap.add_argument("--child", nargs=2, metavar=("CELL", "ROUTE"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--profile", choices=("torch", "python"))
    args = ap.parse_args()
    if args.child:
        return child(*args.child, args)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_first_solve: needs a CUDA device (or --device cpu)")
    sys.path.insert(0, ROOT)
    import chip_smoke as cm

    card = cm.card_line() if args.device == "cuda" else "cpu"
    roots = [("this", ROOT)] + ([("other", os.path.abspath(args.other))] if args.other else [])
    if args.device == "cuda":
        for label, root in roots:  # the kernels built once, before any timed process
            subprocess.run([sys.executable, "-c", "from krylov_tpu_torch import _build; "
                            "_build.build()"], cwd=root, check=True)
    print(f"[{card}] torch {torch.__version__}, cuda {torch.version.cuda}; "
          f"{args.processes} fresh processes a route, cells {args.cells}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    cells = args.cells.split(",")
    rows = {}
    for cell in cells:
        for i in range(args.processes):
            for route in ("host", "rule")[:: 1 if i % 2 == 0 else -1]:
                for label, root in roots[:: 1 if i % 2 == 0 else -1]:
                    got, _ = spawn(root, label, cell, route, args)
                    rows.setdefault((cell, route, label), []).append(got)
    print(f"[{card}] medians (spread) over {args.processes} processes, ms; import s", flush=True)
    for (cell, route, label), got in rows.items():
        parts = ", ".join(
            f"{k[:-2]} {m * 1e3:.1f} ({s * 1e3:.1f})"
            for k in cm.FIRST_PARTS for m, s in [median_spread(g[k] for g in got)] if m is not None)
        first, fs = median_spread(g["first_s"] for g in got)
        second, ss = median_spread(g["second_s"] for g in got)
        imp, _ = median_spread(g["import_s"] for g in got)
        print(f"[{card}] {cell} {route} {label}: first {first * 1e3:.1f} ({fs * 1e3:.1f}), "
              f"second {second * 1e3:.1f} ({ss * 1e3:.1f}); import {imp:.2f} s; modules the "
              f"first imported {[g['imported'] for g in got]}, named "
              f"{sorted({m for g in got for m in g['named']})}; captures "
              f"{[g['captures'] for g in got]}, kept {[g['kept'] for g in got]}; {parts}",
              flush=True)
    if args.trace:
        for cell in args.trace_cells.split(","):
            for label, root in roots:
                for profile in ("torch", "python"):
                    if label != "this" and (profile == "torch" or cell != "cg_jacobi"):
                        continue  # the other checkout: its first solve's Python profile
                    got, err = spawn(root, label, cell, "rule", args, profile)
                    print(f"[{card}] {cell} rule {label}, profiled ({profile}): first "
                          f"{got['first_s'] * 1e3:.1f} ms, second {got['second_s'] * 1e3:.1f}",
                          flush=True)
                    if profile == "python":
                        name = os.path.join(args.out, f"{label}_{cell}_cprofile.txt")
                        with open(name, "w") as f:
                            f.write(err)
                        lines = [ln for ln in err.splitlines() if ln.strip()]
                        print("\n".join(lines[:60]), flush=True)
                    else:
                        logdir = os.path.join(args.out, f"{label}_{cell}_rule")
                        for part, (mark_ms, rows) in trace_summary(logdir).items():
                            print(f"  {cell} trace, {part}"
                                  + (f" ({mark_ms:.3f} ms in its ranges)" if mark_ms else "")
                                  + ":", flush=True)
                            for ms, n, what in rows:
                                print(f"    {ms:10.3f} ms {n:7d}x  {what}", flush=True)


if __name__ == "__main__":
    main()
