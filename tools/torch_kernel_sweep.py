#!/usr/bin/env python3
"""Sweep the tuning constants of K10 (CSR SpMV), K11 (CSR SpMM), K2 (const
stencil matvec) and K12 (BSR SpMM) on one NVIDIA GPU, and time a second
checkout beside this one.

Run from the root of the repository on a machine with one CUDA device
(Hopper) and ``nvcc``:

    python3 tools/torch_kernel_sweep.py                  # the default build
    python3 tools/torch_kernel_sweep.py --k2 KRYLOV_K2_STAGES=2,4,8 KRYLOV_K2_RUN=32,128
    python3 tools/torch_kernel_sweep.py --k10 KRYLOV_SPMV_LANE_ENTRIES=2,8 --capacity 1024,2048,4096,8192
    python3 tools/torch_kernel_sweep.py --only k11 --k11 KRYLOV_SPMM_BATCH=2,8 --capacity 1024,2048
    python3 tools/torch_kernel_sweep.py --k12 KRYLOV_BSR_STAGES=2,4 KRYLOV_BSR_WARPS=2,8
    python3 tools/torch_kernel_sweep.py --other DIR      # and the checkout at DIR, in turns
    python3 tools/torch_kernel_sweep.py --only k11 --other DIR   # one kernel's shapes only

Each ``NAME=v1,v2`` builds one library per value (the other constants at
their defaults) with ``krylov_tpu_torch._build.build(defines=...)``, all
builds started together.  Every variant is first held to the plain PyTorch
version (1e-5 of the largest entry: float32 sums in another order), then
timed: ``graph`` is the device time of one launch inside a replayed CUDA
graph of 20 (no host in the loop), ``loop`` the CUDA-event time of a Python
loop of launches as ``chip_smoke.py`` takes it (it includes whatever the
host cannot hide).  ``--other DIR`` runs this script's ``--shapes-only``
mode in DIR in a subprocess before and after, so two commits are compared
within one call on one card.  Lines carry the card's name and power limit.
"""

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BIG = 4096


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def loop_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, launches=20, replays=10):
    """Device time of one ``fn()`` inside a CUDA graph of ``launches``."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (launches * replays)


def both_us(fn, graph=True):
    out = {"loop_us": round(loop_ms(fn) * 1e3, 2)}
    if graph:
        out["graph_us"] = round(graph_ms(fn) * 1e3, 2)
    return out


def band_sets(st):
    """K2's band sets at 4096^2: the identity (one band: the kernel's
    floor, a copy through its loads and stores), the 5-point Laplacian, and
    seeded 9- and 25-band stencils (every offset in [-1, 1]^2 and
    [-2, 2]^2)."""
    rng = np.random.default_rng(5)
    sets = {"1": st.ConstStencilOperator((BIG, BIG), [(0, 0)], [1.0]).kernel_bands,
            "5": st.poisson_2d_const(BIG).kernel_bands}
    for h in (1, 2):
        offs = [(a, b) for a in range(-h, h + 1) for b in range(-h, h + 1)]
        op = st.ConstStencilOperator((BIG, BIG), offs, list(rng.standard_normal(len(offs))))
        sets[str(len(offs))] = op.kernel_bands
    return sets


def k10_cases(sv, dev):
    """(label, operator-side CSR object, x) for the irregular matrix, its
    adjoint, its bf16 values and the shifted Poisson CSR, as PETOperator
    holds them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rng = np.random.default_rng(44)
    irr, lap = chip_smoke.irregular_csr(), chip_smoke.poisson_csr(chip_smoke.NPG)
    x = torch.from_numpy(rng.standard_normal(irr.shape[0]).astype(np.float32)).to(dev)
    op = sv.PETOperator.from_scipy(irr, with_rmatvec=True, device=dev)
    op16 = sv.PETOperator.from_scipy(irr, with_rmatvec=False, data_dtype=torch.bfloat16,
                                     device=dev)
    pop = sv.PETOperator.from_scipy(lap, with_rmatvec=False, device=dev)
    return [("irregular f32", op._csr, x), ("irregular adjoint f32", op._csr_t, x),
            ("irregular bf16", op16._csr, x), ("poisson 1024^2 f32", pop._csr, x[:lap.shape[0]])]


K11_KS = (1, 4, 8, 16, 17, 32, 33)


def k11_cases(sv, dev):
    """(label, operator-side CSR object, X) for K11: the irregular matrix
    and the shifted Poisson CSR as PETOperator holds them, at every k of
    ``K11_KS``, and the Poisson CSR with bf16 values at k = 8 and 16."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rng = np.random.default_rng(46)
    irr, lap = chip_smoke.irregular_csr(), chip_smoke.poisson_csr(chip_smoke.NPG)
    mats = [("irregular", sv.PETOperator.from_scipy(irr, with_rmatvec=False, device=dev)._csr),
            (f"poisson {chip_smoke.NPG}^2",
             sv.PETOperator.from_scipy(lap, with_rmatvec=False, device=dev)._csr)]
    cases = []
    for label, csr in mats:
        for k in K11_KS:
            X = torch.from_numpy(rng.standard_normal((csr.shape[1], k)).astype(np.float32))
            cases.append((f"{label} f32 k={k}", csr, X.to(dev)))
    p16 = sv.PETOperator.from_scipy(lap, with_rmatvec=False, data_dtype=torch.bfloat16,
                                    device=dev)._csr
    cases += [(f"poisson {chip_smoke.NPG}^2 bf16 k={X.shape[1]}", p16, X) for _, csr, X in cases
              if csr is mats[1][1] and X.shape[1] in (8, 16)]
    return cases


def measure_k11(sv, dev, capacities, library=False):
    cases = k11_cases(sv, dev)
    out = {}
    if library:  # torch.sparse_csr_tensor @ X at k = 8 and 16: the yardstick
        out = measure_library([c for c in cases if c[2].shape[1] in (8, 16)])
    own = getattr(sv, "RUN_CAPACITY", None)
    for cap in capacities:
        for label, csr, X in cases:
            if cap is not None:  # this tree's wrapper: re-cut the runs at this capacity
                sv.RUN_CAPACITY = cap
                csr.runs = torch.from_numpy(sv.csr_runs(csr.indptr.cpu().numpy(), cap)).to(dev)
            want = sv.csr_matvec_plain(csr.indptr, csr.indices, csr.data, X)
            err = check(f"K11 {label} cap {cap}", csr.apply(X), want)
            key = label if cap is None else f"{label} cap={cap}"
            out[key] = dict(both_us(lambda: csr.apply(X)), err=err)
    if own is not None:
        sv.RUN_CAPACITY = own
    return out


def check(name, got, want):
    err = float((got.double() - want.double()).abs().max())
    bound = 1e-5 * float(want.double().abs().max())
    if not err <= bound:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} above {bound:.3e}")
    return err


def measure_library(cases):
    """``torch.sparse_csr_tensor @ x`` on the float32 cases: the one PyTorch
    call computing K10's or K11's function (a yardstick; the port never
    calls it)."""
    out = {}
    for label, csr, x in cases:
        if csr.data.dtype == torch.float32:
            lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                          size=(csr.indptr.numel() - 1, x.shape[0]))
            try:
                out[f"library {label}"] = both_us(lambda: lib @ x)
            except RuntimeError:  # the library call does not capture into a graph
                torch.cuda.synchronize()
                out[f"library {label}"] = both_us(lambda: lib @ x, graph=False)
    return out


def measure_k10(sv, dev, capacities, library=False):
    cases = k10_cases(sv, dev)
    out = measure_library(cases) if library else {}
    own = getattr(sv, "RUN_CAPACITY", None)
    for cap in capacities:
        for label, csr, x in cases:
            if cap is not None:  # this tree's wrapper: re-cut the runs at this capacity
                sv.RUN_CAPACITY = cap
                csr.runs = torch.from_numpy(sv.csr_runs(csr.indptr.cpu().numpy(), cap)).to(dev)
            want = sv.csr_matvec_plain(csr.indptr, csr.indices, csr.data, x)
            err = check(f"K10 {label} cap {cap}", csr.apply(x), want)
            key = label if cap is None else f"{label} cap={cap}"
            out[key] = dict(both_us(lambda: csr.apply(x)), err=err)
    if own is not None:
        sv.RUN_CAPACITY = own
    return out


def measure_k2(cs, st, dev):
    out = {}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((BIG, BIG)).astype(np.float32)).to(dev)
    y = torch.empty_like(x)
    # the same grid 4 bytes off a 16-byte boundary: the general kernel's case
    store = torch.empty(BIG * BIG + 4, dtype=torch.float32, device=dev)
    xo = store[1:1 + BIG * BIG].view(BIG, BIG).copy_(x)
    # the card's rate for one write per read: PyTorch's copy of the same 2*N*4 bytes
    out["torch copy_ of the grid"] = both_us(lambda: y.copy_(x))
    for label, kb in band_sets(st).items():
        want = cs.const_stencil2d_matvec_plain(x, kb)
        for tag, xx in (("aligned", x), ("offset view", xo)):
            err = check(f"K2 {label} bands {tag}", cs.const_stencil2d_matvec(xx, kb, out=y), want)
            out[f"{label} bands {tag}"] = dict(
                both_us(lambda: cs.const_stencil2d_matvec(xx, kb, out=y)), err=err)
    return out


def k12_cases(dev):
    """(label, data, cols, X, the scipy BSR matrix or None) for K12: the
    block-tridiagonal SPD matrix of ``chip_smoke.py``'s phase 6c (4096 block
    rows x 3 blocks of 32^2) at k = 1, 8 and 16, and 256 block rows x 3
    random blocks of 128^2 at k = 1 and 8."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from krylov_tpu_torch import as_operator

    rng = np.random.default_rng(45)
    bsp = chip_smoke.block_spd_csr()
    bop = as_operator(bsp, dev)
    bsr = bsp.tobsr(blocksize=(32, 32))
    bsr.sort_indices()
    cases = []
    for k in (1, 8, 16):
        X = torch.from_numpy(rng.standard_normal((bop.shape[1], k)).astype(np.float32)).to(dev)
        cases.append((f"{bop.cols.shape[0]} x {bop.cols.shape[1]} blocks of 32^2 k={k}",
                      bop.data, bop.cols, X, bsr if k == 8 else None))
    nbrows, max_blocks, R = 256, 3, 128
    cols = torch.from_numpy(rng.integers(0, nbrows, (nbrows, max_blocks)).astype(np.int32)).to(dev)
    blocks = torch.from_numpy(rng.standard_normal((nbrows * max_blocks, R, R))
                              .astype(np.float32)).to(dev)
    for k in (1, 8):
        X = torch.from_numpy(rng.standard_normal((nbrows * R, k)).astype(np.float32)).to(dev)
        cases.append((f"{nbrows} x {max_blocks} blocks of {R}^2 k={k}", blocks, cols, X, None))
    return cases


def measure_k12(bs, dev, library=False):
    out = {}
    for label, data, cols, X, bsr in k12_cases(dev):
        err = check(f"K12 {label}", bs.bsr_spmm(data, cols, X), bs.bsr_spmm_plain(data, cols, X))
        out[label] = dict(both_us(lambda: bs.bsr_spmm(data, cols, X)), err=err)
        if library and bsr is not None:
            # the one PyTorch call computing K12's function (timed only): the
            # same blocks without the ELL padding
            lib = torch.sparse_bsr_tensor(
                torch.from_numpy(bsr.indptr.astype(np.int64)).to(dev),
                torch.from_numpy(bsr.indices.astype(np.int64)).to(dev),
                torch.from_numpy(bsr.data.astype(np.float32)).to(dev), size=bsr.shape)
            try:
                out[f"library {label}"] = both_us(lambda: lib @ X)
            except RuntimeError:  # the library call does not capture into a graph
                torch.cuda.synchronize()
                out[f"library {label}"] = both_us(lambda: lib @ X, graph=False)
            out[f"plain {label}"] = both_us(lambda: bs.bsr_spmm_plain(data, cols, X))
    paths = getattr(bs, "K12_PATHS", None)
    if paths is not None:
        out["launches by kernel"] = dict(paths)
    return out


def use_library(path, build, *wrappers):
    """Point the wrappers at the library at ``path``."""
    build.load = lambda: ctypes.CDLL(str(path))
    for w in wrappers:
        w._lib.cache_clear()


def shapes_only(args):
    """Time the default build of the package in the current directory."""
    sys.path.insert(0, ".")
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    dev = torch.device("cuda", 0)
    _build.build()
    res = {}
    if "k10" in args.only:
        res["k10"] = measure_k10(sv, dev, [None])
    if "k11" in args.only:
        res["k11"] = measure_k11(sv, dev, [None])
    if "k2" in args.only:
        res["k2"] = measure_k2(cs, st, dev)
    if "k12" in args.only:
        res["k12"] = measure_k12(bs, dev)
    print(json.dumps(res), flush=True)


def run_other(where, card, only):
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--shapes-only",
                          "--only", ",".join(only)],
                         cwd=where, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"--other {where} failed:\n{out.stdout}\n{out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for part, rows in res.items():
        for key, row in rows.items():
            print(f"[{card}] other {where} {part} {key}: {row}", flush=True)


def variants_of(specs):
    """``NAME=v1,v2`` specs as a list of define tuples, one constant varied
    at a time, after the default build ``()``."""
    out = [()]
    for spec in specs or ():
        name, values = spec.split("=")
        out += [(f"{name}={v}",) for v in values.split(",")]
    return out


def full_grid(specs):
    names = [s.split("=")[0] for s in specs]
    values = [s.split("=")[1].split(",") for s in specs]
    return [tuple(f"{n}={v}" for n, v in zip(names, combo))
            for combo in itertools.product(*values)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k2", nargs="*", default=None, metavar="NAME=v1,v2")
    ap.add_argument("--k10", nargs="*", default=None, metavar="NAME=v1,v2")
    ap.add_argument("--k11", nargs="*", default=None, metavar="NAME=v1,v2")
    ap.add_argument("--k12", nargs="*", default=None, metavar="NAME=v1,v2")
    ap.add_argument("--only", default="k10,k11,k2,k12",
                    help="kernels whose default build is timed, here and with --other")
    ap.add_argument("--grid", action="store_true",
                    help="build every combination of the values, not one constant at a time")
    ap.add_argument("--capacity", default=None,
                    help="K10 and K11 run capacities to sweep, comma-separated (default: the "
                         "wrapper's)")
    ap.add_argument("--other", default=None, help="a second checkout to time beside this one")
    ap.add_argument("--shapes-only", action="store_true")
    args = ap.parse_args()
    args.only = args.only.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_sweep: no CUDA device")
    if args.shapes_only:
        return shapes_only(args)

    sys.path.insert(0, str(ROOT))
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    card = card_line()
    dev = torch.device("cuda", 0)
    if all(v is None for v in (args.k2, args.k10, args.k11, args.k12)):
        # no sweep asked for: the default build of the kernels of --only
        args.k10 = [] if "k10" in args.only else None
        args.k11 = [] if "k11" in args.only else None
        args.k2 = [] if "k2" in args.only else None
        args.k12 = [] if "k12" in args.only else None
    expand = full_grid if args.grid else variants_of
    k2_variants = expand(args.k2) if args.k2 is not None else []
    k10_variants = expand(args.k10) if args.k10 is not None else []
    k11_variants = expand(args.k11) if args.k11 is not None else []
    k12_variants = expand(args.k12) if args.k12 is not None else []
    wanted = sorted(set(k2_variants) | set(k10_variants) | set(k11_variants)
                    | set(k12_variants) | {()})
    built = {}

    def build_one(defines):
        try:
            built[defines] = _build.build(defines)
        except RuntimeError as e:  # a variant the sources refuse: reported, not swept
            failed[defines] = str(e).strip().splitlines()[-1]

    failed = {}
    threads = [threading.Thread(target=build_one, args=(d,)) for d in wanted]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for defines, why in failed.items():
        print(f"build of {defines} failed: {why}", flush=True)
    k2_variants = [d for d in k2_variants if d in built]
    k10_variants = [d for d in k10_variants if d in built]
    k11_variants = [d for d in k11_variants if d in built]
    k12_variants = [d for d in k12_variants if d in built]
    for defines in sorted(built):
        path, seconds, log = built[defines]
        print(f"built {defines or 'default'} in {seconds:.1f} s", flush=True)
        lines = log.splitlines()
        for k, line in enumerate(lines):  # registers, shared memory and spills of the kernels swept
            if "Compiling entry function" in line and any(
                    name in line for name in ("csr_stream", "csr_spmm", "tiled",
                                              "bsr_spmm_streamed")):
                print("   ", line.split("'")[1][:60], "|", " ".join(
                    q.split(":", 1)[1].strip() for q in lines[k + 1:k + 4] if "Used" in q),
                    flush=True)

    if args.other:
        run_other(args.other, card, args.only)
    caps = [int(c) for c in args.capacity.split(",")] if args.capacity else [None]
    for defines in k10_variants:
        use_library(built[defines][0], _build, cs, sv, bs)
        for key, row in measure_k10(sv, dev, caps, library=not defines).items():
            print(f"[{card}] K10 {defines or 'default'} {key}: {row}", flush=True)
    for defines in k11_variants:
        use_library(built[defines][0], _build, cs, sv, bs)
        for key, row in measure_k11(sv, dev, caps, library=not defines).items():
            print(f"[{card}] K11 {defines or 'default'} {key}: {row}", flush=True)
    for defines in k2_variants:
        use_library(built[defines][0], _build, cs, sv, bs)
        for key, row in measure_k2(cs, st, dev).items():
            print(f"[{card}] K2 {defines or 'default'} {key}: {row}", flush=True)
    for defines in k12_variants:
        use_library(built[defines][0], _build, cs, sv, bs)
        for key, row in measure_k12(bs, dev, library=not defines).items():
            print(f"[{card}] K12 {defines or 'default'} {key}: {row}", flush=True)
    if args.other:
        run_other(args.other, card, args.only)


if __name__ == "__main__":
    main()
