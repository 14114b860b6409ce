#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` alone on one NVIDIA GPU, S1's and S2's
tuning constants timed, this tree's sweeps against another's, and the
latency of the sweeps' hand-offs.

    python3 tools/torch_sweeps.py                 # phase 8: the stationary path
    python3 tools/torch_sweeps.py --variants cluster=1,4,8,16 --variants window=0,1
    python3 tools/torch_sweeps.py --cold --variants window=0 --grids 256,512,1024
    python3 tools/torch_sweeps.py --variants KRYLOV_SWEEP_PRE=1,3
    python3 tools/torch_sweeps.py --against _archive/parent [--repeats 40]
    python3 tools/torch_sweeps.py --handoff       # a cluster barrier + DSMEM read, a block barrier + shared read
    python3 tools/torch_sweeps.py --trace         # where a sweep step's device time goes

Phase 8: S1 and S2 (the triangular-sweep kernels) against their plain
versions, timed, and the sweep solvers at full width on the rule's route
against the host-stepped loop; it prints what phase 8 prints, then the
launches it counted and S1's and S2's errors and timing records as one
JSON line.

``--variants NAME=v1,v2,...`` times S1 (poisson_2d at 4096^2 and 1024^2,
float32, lower) and S2 (ILU(0) L at each of ``--grids``, 256^2 and 1024^2
unless given) with each value, by CUDA events, every result held to the
default's bit for bit or to the plain loop.  NAME is a constant of
``ops/cuda_triangular.py`` — ``cluster`` (S1's CTAs a right-hand side),
``threads`` (S1's workers a CTA), ``strip`` (``SWEEP_STRIP``), ``window``
(``LEVEL_WINDOW_MAX``, W's cap; 0: no window) — or a macro of
``csrc/triangular.cu``, for which ``csrc/`` is built once a value
(``_build.build(defines=...)``).

``--against DIR`` loads the package unpacked at ``DIR`` (``git archive
<commit> krylov_tpu_torch | tar -x -C DIR``) under another name, builds its
``csrc/`` into its own build directory, and times both trees' S1
(poisson_2d at 4096^2 and 1024^2, f32, lower and upper) and S2 (ILU(0) L
and U at 256^2 and 1024^2, the unstructured 2^20-row L) in turns (other,
this, this, other, ...), one sweep a timing by CUDA events, in one
process: medians of ``--repeats`` with the interquartile range and the
spread (max - min), the repeats in which this tree's sweep was the faster
of the pair, each tree's sweep bit-equal on a repeat, the trees' results
within float32 rounding.  With ``--cold`` every timed sweep (of
``--against`` and ``--variants``) follows a write of 256 MiB, so that it
finds none of its operands in the L2 cache; without it a sweep timed right
after another of its own finds them there.

``--handoff`` builds ``tools/sweep_handoff.cu`` and times one hand-off of
each chain: a cluster barrier plus a read of another CTA's shared memory
(S1's rows, clusters of 2 to 16 CTAs) and a block barrier plus a
shared-memory read (S2's levels), by CUDA events over 20000 steps.

Run from the root of the repository; the card's name and power limit head
and end the output.
"""

import argparse
import ctypes
import glob
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PY_CONSTANTS = {"cluster": None, "threads": None, "strip": "SWEEP_STRIP",
                "window": "LEVEL_WINDOW_MAX"}


def load_other(root, name="krylov_tpu_torch_other"):
    """The package at ``root/krylov_tpu_torch`` under ``name``."""
    pkg = os.path.join(os.path.abspath(root), "krylov_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# --cold: a buffer larger than the card's L2 cache (50 MB on the H100),
# written before each timed call so that the call finds nothing of its own
# in the cache; None times each call as the previous calls left the cache
EVICT = None


def event_ms(fn):
    """One call of ``fn`` timed by CUDA events, in ms."""
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if EVICT is not None:
        EVICT.zero_()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def sweep_cases(kt, smoke, dev, s1=(4096, 1024), uppers=(False, True), s2=(256, 1024),
                unstructured=True, s1_kw=None):
    """``[(label, sweep, b, chain)]`` of one package ``kt``: S1 on poisson_2d
    (f32) and S2 on ILU(0) of ``smoke.grid_csr`` and the unstructured
    matrix; the inputs made from fixed seeds, so both trees get the same."""
    import scipy.sparse

    st = importlib.import_module(f"{kt.__name__}.ops.stencil")
    tri = importlib.import_module(f"{kt.__name__}.ops.triangular")
    ct = importlib.import_module(f"{kt.__name__}.ops.cuda_triangular")
    cases = []
    for n in s1:
        A = st.poisson_2d(n, dtype=np.float32, device=dev)
        b = torch.from_numpy(np.random.default_rng(n).standard_normal((n, n)).astype(
            np.float32)).to(dev)
        for upper in uppers:
            sweep = (tri.GridUpperSweep if upper else tri.GridLowerSweep)(
                A.coeffs2d, A.row_offsets, A.col_offsets)
            if s1_kw:
                sweep.plan = ct.grid_plan(A.coeffs2d, A.row_offsets, A.col_offsets, 1.0,
                                          torch.float32, upper, **s1_kw)
            cases.append((f"S1 {'upper' if upper else 'lower'} {n}^2", sweep, b, n))
    for g in s2:
        M = kt.ILUPreconditioner.from_scipy(smoke.grid_csr(g, 0.5, 0.4), device=dev)
        r = torch.from_numpy(np.random.default_rng(g).standard_normal(g * g).astype(
            np.float32)).to(dev)
        for label, sweep in (("L", M._l), ("U", M._u))[:len(uppers)]:
            cases.append((f"S2 ILU(0) {label} {g}^2", sweep, r, sweep.nlevels))
    if unstructured:
        sp = smoke.unstructured_spd(smoke.NLEVEL)
        sweep = tri.make_triangular_solve(scipy.sparse.tril(sp).tocsr(), lower=True, device=dev)
        r = torch.from_numpy(np.random.default_rng(7).standard_normal(smoke.NLEVEL).astype(
            np.float32)).to(dev)
        cases.append((f"S2 unstructured L {smoke.NLEVEL}", sweep, r, sweep.nlevels))
    return cases


def shape_text(sweep):
    from krylov_tpu_torch.ops import cuda_triangular as ct

    if hasattr(sweep, "schedule"):
        return "runs' windows W " + str(sweep.schedule.windows(1, 4))
    info = ct.grid_sweep_info(sweep.plan)
    return (f"cluster {info['cluster']} x {info['threads']} threads, per {info['per']}, "
            f"seg {info['seg']}, ring in smem {info['in_smem']}, fetch {info['fetch']}")


def variants(spec, smoke, card, kt, grids, repeats):
    """Time S1 and S2 with each value of one constant (module doc): each
    value's sweeps made and checked with the constant set, then every
    value's sweep of a case timed in turns, ``repeats`` times."""
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_triangular as ct

    dev = torch.device("cuda", 0)
    name, values = spec.split("=")
    base = sweep_cases(kt, smoke, dev, uppers=(False,), s2=grids, unstructured=False)
    want = [sweep(b) for _, sweep, b, _ in base]
    default_lib = ct._lib
    saved = {k: getattr(ct, k) for k in PY_CONSTANTS.values() if k}
    arms = []  # (label, lib, [(case index, sweep, b, shape text)])
    for v in [None] + values.split(","):
        label = "default" if v is None else f"{name}={v}"
        cases, lib = base, default_lib
        if v is not None and name in PY_CONSTANTS:
            s1_kw = {name: int(v)} if name in ("cluster", "threads") else None
            if PY_CONSTANTS[name]:
                setattr(ct, PY_CONSTANTS[name], int(v))
            cases = sweep_cases(kt, smoke, dev, uppers=(False,), s2=grids, unstructured=False,
                                s1_kw=s1_kw)
        elif v is not None:
            path, seconds, _ = _build.build((f"{name}={v}",))
            print(f"  [{card}] {label}: built in {seconds:.1f} s", flush=True)
            lib = (lambda lib: lambda: lib)(ct.bind(ctypes.CDLL(str(path))))
            ct._lib = lib
        ran = []
        for i, ((lab, sweep, b, _), ref) in enumerate(zip(cases, want)):
            try:
                got = sweep(b)  # a level schedule's launch table is made here, once
            except (RuntimeError, ValueError) as exc:
                print(f"  [{card}] {label} {lab}: refused ({str(exc)[:120]})", flush=True)
                continue
            print(f"  [{card}] {label} {lab}: {shape_text(sweep)}; bit-equal to the default "
                  f"{torch.equal(got, ref)}, max abs difference "
                  f"{float((got - ref).abs().max()):.3e}", flush=True)
            ran.append((i, sweep, b))
        arms.append((label, lib, ran))
        ct._lib = default_lib
        for k, val in saved.items():
            setattr(ct, k, val)
    for i, (lab, _, _, chain) in enumerate(base):
        times = {}
        for rep in range(repeats):
            for label, lib, ran in arms[::1 if rep % 2 == 0 else -1]:
                for j, sweep, b in ran:
                    if j == i:
                        ct._lib = lib
                        times.setdefault(label, []).append(event_ms(lambda: sweep(b)))
        ct._lib = default_lib
        for label, t in times.items():
            med = float(np.median(t))
            iqr = float(np.subtract(*np.percentile(t, [75, 25])))
            print(f"  [{card}] {label} {lab}: {med * 1e3:.1f} us (median of {len(t)} in turns; "
                  f"IQR {iqr * 1e3:.1f}, spread {(max(t) - min(t)) * 1e3:.1f}; "
                  f"{med * 1e3 / chain:.3f} us a row or level)", flush=True)


def against(root, repeats, smoke, card, kt, grids):
    """This tree's S1 and S2 against the tree at ``root``, in turns."""
    dev = torch.device("cuda", 0)
    other = load_other(root)
    path, seconds, _ = importlib.import_module(f"{other.__name__}._build").build()
    print(f"  other tree's kernels built in {seconds:.1f} s -> {path}", flush=True)
    trees = {"this": sweep_cases(kt, smoke, dev, s2=grids),
             "other": sweep_cases(other, smoke, dev, s2=grids)}
    print("case | this us median (IQR; spread) | other us median (IQR; spread) | this / other "
          "| pairs this wins | this us a row or level | launch shape (this)", flush=True)
    out = []
    for i, (label, _, _, chain) in enumerate(trees["this"]):
        got = {w: trees[w][i][1](trees[w][i][2]) for w in trees}
        for w in trees:
            assert torch.equal(trees[w][i][1](trees[w][i][2]), got[w]), (w, label)
        ref = got["other"]
        err = float((got["this"] - ref).abs().max()) / float(ref.abs().max())
        times = {"this": [], "other": []}
        for rep in range(repeats):
            for w in ("other", "this") if rep % 2 == 0 else ("this", "other"):
                _, sweep, b, _ = trees[w][i]
                times[w].append(event_ms(lambda: sweep(b)))
        med = {w: float(np.median(t)) for w, t in times.items()}
        iqr = {w: float(np.subtract(*np.percentile(t, [75, 25]))) for w, t in times.items()}
        spread = {w: max(t) - min(t) for w, t in times.items()}
        wins = sum(t < o for t, o in zip(times["this"], times["other"]))  # a repeat's pair
        print(f"{label} | {med['this'] * 1e3:.1f} ({iqr['this'] * 1e3:.1f}; "
              f"{spread['this'] * 1e3:.1f}) | {med['other'] * 1e3:.1f} ({iqr['other'] * 1e3:.1f}; "
              f"{spread['other'] * 1e3:.1f}) | "
              f"{med['this'] / med['other']:.3f} | {wins} of {repeats} | "
              f"{med['this'] * 1e3 / chain:.3f} | "
              f"{shape_text(trees['this'][i][1])}; this vs other max abs difference "
              f"{err:.2e} of the largest value", flush=True)
        out.append({"case": label, "this_us": med["this"] * 1e3, "this_iqr_us":
                    iqr["this"] * 1e3, "this_spread_us": spread["this"] * 1e3,
                    "other_us": med["other"] * 1e3, "other_iqr_us": iqr["other"] * 1e3,
                    "other_spread_us": spread["other"] * 1e3, "pairs_won": wins,
                    "chain": chain})
        del got
    print(json.dumps({"against": root, "card": card, "repeats": repeats, "cases": out}),
          flush=True)


def handoff(card):
    """One hand-off's latency (module doc)."""
    from krylov_tpu_torch import _build

    out_dir = tempfile.mkdtemp(prefix="sweep_handoff_")
    lib_path = os.path.join(out_dir, "libhandoff.so")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(HERE, "tools", "sweep_handoff.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.sweep_handoff.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
                                  + [ctypes.c_longlong, ctypes.c_void_p])
    out = torch.zeros(1024, device="cuda")
    nbig = 1 << 28  # 1 GiB of floats a buffer: the loads and stores miss the L2 cache
    big = torch.ones(nbig, device="cuda")
    sink = torch.zeros(nbig, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    steps = 20000
    rows = []
    cases = ([(0, C, 256, 0, 0) for C in (2, 4, 8, 16)] + [(0, 4, 1024, 0, 0)]
             + [(0, 8, 256, m, rel) for m in (1, 2) for rel in (0, 1)]
             + [(1, 1, 1024, m, 0) for m in (0, 1, 2)] + [(1, 1, 256, 0, 0)])
    for kind, C, nt, mode, relaxed in cases:
        def run():
            err = lib.sweep_handoff(kind, C, nt, steps, mode, relaxed,
                                    ctypes.c_void_p(out.data_ptr()),
                                    ctypes.c_void_p(big.data_ptr()),
                                    ctypes.c_void_p(sink.data_ptr()), nbig, stream)
            if err:
                raise RuntimeError(f"sweep_handoff: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        ms = sorted(event_ms(run) for _ in range(5))[2]
        extra = ("", ", a device-memory load in flight", ", a device-memory store before")[mode]
        what = (f"cluster of {C} CTAs x {nt} threads: barrier.cluster (arrive."
                f"{'relaxed' if relaxed else 'release'}) + DSMEM read{extra}"
                if kind == 0 else
                f"one CTA of {nt} threads: __syncthreads + shared read{extra}")
        print(f"  [{card}] hand-off, {what}: {ms * 1e6 / steps:.1f} ns a step "
              f"(median of 5 launches of {steps} steps)", flush=True)
        rows.append({"kind": "cluster" if kind == 0 else "block", "ctas": C, "threads": nt,
                     "mode": mode, "relaxed": relaxed, "ns": ms * 1e6 / steps})
    del big, sink
    shutil.rmtree(out_dir)
    print(json.dumps({"handoff": rows, "card": card}), flush=True)


def trace(smoke, card):
    """Where a sweep step's device time goes: ``profiling.trace`` around
    three ``gauss_seidel`` steps at 4096^2 and around an ILU(0) application
    at 1024^2, each trace summed by kernel, and the same calls under a
    profiler of the device's activity alone (``chip_smoke.device_busy``'s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import profiling
    from krylov_tpu_torch.ops import stencil as st

    dev = torch.device("cuda", 0)
    A = st.poisson_2d(4096, dtype=np.float32, device=dev)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(4096 * 4096).astype(
        np.float32)).to(dev)
    M = kt.ILUPreconditioner.from_scipy(smoke.grid_csr(1024, 0.5, 0.4), device=dev)
    r = b[:1024 * 1024].clone()
    cases = {
        "gauss_seidel, 3 steps at 4096^2": lambda: kt.gauss_seidel(
            A, b, tol=1e-30, maxiter=3, backend="while_loop"),
        "one ILU(0) application at 1024^2": lambda: M @ r,
    }
    out = tempfile.mkdtemp(prefix="sweeps_trace_")  # the traces, removed once summed
    for label, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        for what, activities in (("CPU and CUDA activity", [ProfilerActivity.CPU,
                                                            ProfilerActivity.CUDA]),
                                 ("CUDA activity alone", [ProfilerActivity.CUDA])):
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = [(e.key, e.self_device_time_total, e.count)
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            show(card, f"{label}, {what}", wall, rows)
        # the Chrome trace profiling.trace writes, its kernel events summed
        before = set(glob.glob(os.path.join(out, "*.json")))
        with profiling.trace(out):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (path,) = set(glob.glob(os.path.join(out, "*.json"))) - before
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        by = {}
        for e in events:
            us, c = by.get(e["name"], (0.0, 0))
            by[e["name"]] = (us + e["dur"], c + 1)
        show(card, f"{label}, profiling.trace ({os.path.getsize(path)} bytes)", wall,
             [(k, us, c) for k, (us, c) in by.items()])
    shutil.rmtree(out)


def show(card, what, wall, rows):
    busy = sum(q[1] for q in rows) * 1e-3
    print(f"  [{card}] {what}: wall {wall * 1e3:.2f} ms, device {busy:.2f} ms in "
          f"{sum(q[2] for q in rows)} kernels; by kernel: " + "; ".join(
              f"{k[:48]} x{c} {us / 1e3:.3f} ms"
              for k, us, c in sorted(rows, key=lambda q: -q[1])[:5]), flush=True)


def main():
    global EVICT
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweeps: no CUDA device")
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", action="append", default=[],
                        help="NAME=v1,v2,...: time S1 and S2 with each value of a constant")
    parser.add_argument("--against", help="the root of another tree to time S1 and S2 against")
    parser.add_argument("--repeats", type=int, default=40,
                        help="timed sweeps a tree or value (--against, --variants)")
    parser.add_argument("--grids", default="256,1024",
                        help="S2's ILU(0) grid sides (--against, --variants)")
    parser.add_argument("--cold", action="store_true",
                        help="evict the L2 cache before each timed sweep (--against, --variants)")
    parser.add_argument("--handoff", action="store_true",
                        help="time a cluster and a block hand-off (the chain bound)")
    parser.add_argument("--trace", action="store_true",
                        help="profile a gauss_seidel solve and an ILU(0) application")
    args = parser.parse_args()
    import chip_smoke as smoke
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    path, seconds, _ = _build.build()
    smoke.log(f"{card}; kernels built in {seconds:.1f} s -> {path.name}")
    if args.variants or args.trace or args.against or args.handoff:
        if args.handoff:
            handoff(card)
        grids = tuple(int(g) for g in args.grids.split(","))
        if args.cold:
            EVICT = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
        if args.against:
            against(args.against, args.repeats, smoke, card, kt, grids)
        for spec in args.variants:
            variants(spec, smoke, card, kt, grids, args.repeats)
        if args.trace:
            trace(smoke, card)
    else:
        t0 = time.perf_counter()
        launches, errs, times = smoke.phase_stationary(torch.device("cuda", 0), kt, cs, sv, st,
                                                       card)
        smoke.log(f"phase 8: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"launches": launches, "errs": errs, "times": times}), flush=True)
    smoke.log(card)


if __name__ == "__main__":
    main()
