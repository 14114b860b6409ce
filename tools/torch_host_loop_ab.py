#!/usr/bin/env python3
"""The host-stepped ``while_loop`` of the methods whose step depends on its
step number, or of the solves that run K11, this checkout against another,
in turns on one NVIDIA GPU.

Run from the root of the repository on a machine with one CUDA device and
``nvcc``, with a second checkout's package unpacked at DIR (``git archive
<commit> krylov_tpu_torch | tar -x -C DIR``):

    python3 tools/torch_host_loop_ab.py --other DIR [--repeats N] [--cells k11]

The solves are ``chip_smoke.counted_solves``'s (phase 13's cells of
``gmres`` x3, ``tfqmr``, ``cg_pipelined``, ``cg_block``, ``symmlq``,
``gcr`` and ``chebyshev``) or, with ``--cells k11``, :func:`k11_solves`'s
(the blocked right-hand sides of phases 6c, 7c, 9 and 13), each on the
host-stepped loop (``_driver._host_stepped()``).  Both packages live in
this one process, the other one imported under the name
``krylov_tpu_torch_other`` (the package imports itself relatively) with
its kernels built from its own sources.  A cell is solved once by each as
a warm-up, then ``N`` times by each in
turns (other, this, this, other, ...), then profiled once by each.  A line
a cell gives the median wall and spread of each, the median of the
differences pair by pair, the device kernels and device-busy time of a
solve (``torch.profiler``), the stop-flag reads a step, whether the
kernel wrappers' launches agree and the device events whose counts
differ, by name.  Every line carries the card's name and power limit.
"""

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_other(root, name="krylov_tpu_torch_other"):
    """The package at ``root/krylov_tpu_torch`` under ``name``."""
    pkg = os.path.join(os.path.abspath(root), "krylov_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def counters(kt):
    """(reset, read) of the package's kernel wrappers' launch counts and
    its driver's stop-flag reads."""
    ops = [importlib.import_module(f"{kt.__name__}.ops.{m}")
           for m in ("cuda_stencil", "cuda_spmv", "cuda_bsr")]
    drv = importlib.import_module(f"{kt.__name__}._driver")

    def reset():
        for m in ops:
            m.reset_launches()
        drv.reset_counts()

    def read():
        return ({k: v for m in ops for k, v in m.LAUNCHES.items() if v},
                drv.COUNTS["flag_reads"])

    return reset, read


def device_events(fn):
    """(device-busy s, {event name: count}) of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows) * 1e-6,
            {e.key: e.count for e in rows})


def k11_solves(dev, kt, st):
    """The solves with an ``(N, 8)`` right-hand side on the 1M-row CSR,
    whose every operator product is K11, as ``(name, solve, inputs)``:
    ``cg`` on the shifted Poisson CSR (phases 6c and 13), ``cg_block`` on it
    (7c and 13), and ``cg`` + AMG on the unshifted one, K11 on every level
    and prolongator (9)."""
    import chip_smoke
    import torch

    lap = chip_smoke.poisson_csr(chip_smoke.NPG)
    lap0 = chip_smoke.poisson_csr(chip_smoke.NPG, 4.0)
    op, op0 = kt.as_operator(lap, dev), kt.as_operator(lap0, dev)
    assert type(op).__name__ == type(op0).__name__ == "PETOperator"
    amg = kt.AMGPreconditioner.from_scipy(lap0, dtype=np.float32, fine_operator=op0, device=dev)
    rng = np.random.default_rng(chip_smoke.SEED + 43)
    B = torch.from_numpy(rng.standard_normal((lap.shape[0], 8)).astype(np.float32)).to(dev)
    wl = dict(backend="while_loop")
    return [
        ("cg, (N, 8) b (K11), 1M-row CSR, to 1e-5", lambda: kt.cg(
            op, B, tol=1e-5, maxiter=300, **wl), (B,)),
        ("cg_block (N, 8) (K11), 1M-row CSR, to 1e-4", lambda: kt.cg_block(
            op, B, tol=1e-4, maxiter=400, **wl), (B,)),
        ("cg + AMG, (N, 8) b (K11), unshifted 1M-row CSR, to 1e-4", lambda: kt.cg(
            op0, B, M=amg, tol=1e-4, maxiter=60, **wl), (B,)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other checkout's root")
    ap.add_argument("--repeats", type=int, default=10, help="timed solves of a cell each")
    ap.add_argument("--cells", choices=("counted", "k11"), default="counted",
                    help="phase 13's counted methods, or the solves that run K11")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_host_loop_ab: no CUDA device; this runs only on a GPU")
    sys.path.insert(0, HERE)
    import chip_smoke
    import krylov_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    pkgs = {"this": krylov_tpu_torch, "other": load_other(args.other)}
    cells, host = {}, {}
    for who, kt in pkgs.items():
        importlib.import_module(f"{kt.__name__}._build").build()
        st = importlib.import_module(f"{kt.__name__}.ops.stencil")
        make = chip_smoke.counted_solves if args.cells == "counted" else k11_solves
        cells[who] = make(dev, kt, st)
        host[who] = importlib.import_module(f"{kt.__name__}._driver")._host_stepped
    for i, (name, _, _) in enumerate(cells["this"]):
        solve = {w: cells[w][i][1] for w in pkgs}
        walls, seen = {w: [] for w in pkgs}, {}
        for w in pkgs:
            with host[w]():
                solve[w]()
        for rep in range(args.repeats):
            for w in ("other", "this") if rep % 2 == 0 else ("this", "other"):
                reset, read = counters(pkgs[w])
                reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with host[w]():
                    _, info = solve[w]()
                torch.cuda.synchronize()
                walls[w].append(time.perf_counter() - t0)
                seen[w] = (int(info.numsteps),) + read()
        busy, names = {}, {}
        for w in pkgs:
            with host[w]():
                busy_s, names[w] = device_events(solve[w])
            busy[w] = busy_s, sum(names[w].values())
        differ = {n: (names["this"].get(n, 0), names["other"].get(n, 0))
                  for n in set(names["this"]) | set(names["other"])
                  if names["this"].get(n, 0) != names["other"].get(n, 0)}
        med = {w: float(np.median(v)) * 1e3 for w, v in walls.items()}
        spread = {w: float(np.ptp(v)) * 1e3 for w, v in walls.items()}
        diff = float(np.median([a - b for a, b in zip(walls["this"], walls["other"])])) * 1e3
        steps = {w: seen[w][0] for w in pkgs}
        print(f"[{card}] {name}: host-stepped, this {med['this']:.3f} ms (spread "
              f"{spread['this']:.3f}), other {med['other']:.3f} ms (spread "
              f"{spread['other']:.3f}), this - other pair by pair {diff:+.3f} ms, median of "
              f"{args.repeats}; steps this {steps['this']}, other {steps['other']}; device "
              f"kernels a step this {busy['this'][1] / steps['this']:.2f}, other "
              f"{busy['other'][1] / steps['other']:.2f}; device busy ms this "
              f"{busy['this'][0] * 1e3:.3f}, other {busy['other'][0] * 1e3:.3f}; flag reads a "
              f"step this {seen['this'][2] / steps['this']:.3f}, other "
              f"{seen['other'][2] / steps['other']:.3f}; wrapper launches equal "
              f"{seen['this'][1] == seen['other'][1]}; device events that differ (this, other) "
              f"{ {n[:90]: c for n, c in sorted(differ.items())} }", flush=True)


if __name__ == "__main__":
    main()
