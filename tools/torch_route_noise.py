#!/usr/bin/env python3
"""Host noise where the cost rule keeps a solve on the host loop: phase 13's
``gmres`` (MGS, Householder, CGS) and ``gcr`` cells of ``chip_smoke.py``
(26 and 18 steps, under the rule's first decision at step 24 or just past
it), the rule's route against the host-stepped loop, 16 solves of each in
ABBA order.  Both routes run the same launches there, so their medians
should agree and a gap between them is the host's.  Three stages: a fresh
process; the same with 1.5M more objects for the GC to track; the same
with the GC off.  Each solve's full collections are timed
(``gc.callbacks``).  Then ``cProfile`` of one solve of each route.

Run from the root of the repository on one CUDA device:

    python3 tools/torch_route_noise.py

It builds the kernels first and prints the card's name and power limit.
"""

import contextlib
import cProfile
import gc
import io
import os
import pstats
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

PAIRS = 8  # ABBA blocks a cell: 16 solves of each route
_gc = []  # (generation, seconds) of the collections since the last clear


def _timed_gc(phase, info):
    if phase == "start":
        _timed_gc.t = time.perf_counter()
    else:
        _gc.append((info["generation"], time.perf_counter() - _timed_gc.t))


def main():
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build, _driver
    from krylov_tpu_torch.ops import stencil as st

    if not torch.cuda.is_available():
        raise SystemExit("torch_route_noise: no CUDA device")
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    _build.build()
    gc.callbacks.append(_timed_gc)
    cells = [c for c in chip_smoke.counted_solves(dev, kt, st)
             if c[0].startswith(("gmres", "gcr"))]
    ctxs = {"H": _driver._host_stepped, "R": contextlib.nullcontext}
    ballast = None
    for stage in ("fresh", "ballast", "nogc"):
        if stage == "ballast":
            ballast = [{"a": i, "b": [i]} for i in range(1_500_000)]
        if stage == "nogc":
            gc.disable()
        print(f"== stage {stage}: tracked objects {len(gc.get_objects())}", flush=True)
        for name, solve, _ in cells:
            for ctx in ctxs.values():
                with ctx():
                    solve()
            walls = {r: [] for r in ctxs}
            full = {r: [] for r in ctxs}
            for rep in range(PAIRS):
                for r in "HRRH" if rep % 2 == 0 else "RHHR":
                    torch.cuda.synchronize()
                    _gc.clear()
                    t0 = time.perf_counter()
                    with ctxs[r]():
                        solve()
                    torch.cuda.synchronize()
                    walls[r].append(time.perf_counter() - t0)
                    full[r].append(sum(t for g, t in _gc if g == 2))
            for r in ctxs:
                w = np.array(walls[r]) * 1e3
                print(f"  {stage} {name} {r}: median {np.median(w):.2f} ms, min {w.min():.2f}, "
                      f"max {w.max():.2f}; gen2 GC ms total {sum(full[r]) * 1e3:.1f} in "
                      f"{sum(1 for x in full[r] if x)} solves; all "
                      + " ".join(f"{x:.1f}" for x in w), flush=True)
        if stage == "fresh":
            name, solve, _ = cells[0]
            for r, ctx in ctxs.items():
                prof = cProfile.Profile()
                with ctx():
                    prof.enable()
                    solve()
                    torch.cuda.synchronize()
                    prof.disable()
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
                print(f"-- cProfile {name} {r}\n" + out.getvalue()[-4000:], flush=True)
    gc.enable()
    del ballast


if __name__ == "__main__":
    main()
