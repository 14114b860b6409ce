#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, in a fresh process: right-hand
sides through solvers built once by ``parallel.make_sharded_solver`` on one
NCCL rank at full width, the graph each keeps from its first capture
against the host-stepped loop, run by run (see ``chip_smoke.phase_kept``).

Run from the root of the repository on one CUDA device:

    python3 tools/torch_kept_graph.py [--runs N]

It builds the kernels first.  Every line is printed as it comes, the card's
name and power limit first; a failed check raises.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=chip_smoke.KEPT_RUNS,
                        help="right-hand sides through each built solver, on each route")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kept_graph: no CUDA device; this runs only on a GPU")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.KEPT_RUNS = args.runs
    card = chip_smoke.card_line()
    chip_smoke.log(card)
    _, seconds, _ = _build.build()
    chip_smoke.log(f"kernels built in {seconds:.1f} s")
    chip_smoke.phase_kept(torch.device("cuda", 0), kt, cs, sv, bs, st, card)
    chip_smoke.log(card)


if __name__ == "__main__":
    main()
