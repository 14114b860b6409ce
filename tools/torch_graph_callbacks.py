#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone, in a fresh process: ``while_loop``
solves with a callback or a ``ShardMonitor`` at full width, the route the
driver's cost rule picks against the host-stepped loop, each with its
callback (see ``chip_smoke.phase_callbacks``).

Run from the root of the repository on one CUDA device:

    python3 tools/torch_graph_callbacks.py [--repeats N]

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
    parser.add_argument("--repeats", type=int, default=chip_smoke.CALLBACK_REPEATS,
                        help="timed solves of each route a cell")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_graph_callbacks: no CUDA device; this runs only on a GPU")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.CALLBACK_REPEATS = args.repeats
    card = chip_smoke.card_line()
    chip_smoke.log(card)
    _, seconds, _ = _build.build()
    chip_smoke.log(f"kernels built in {seconds:.1f} s")
    chip_smoke.phase_callbacks(torch.device("cuda", 0), kt, cs, sv, bs, st, card)
    chip_smoke.log(card)


if __name__ == "__main__":
    main()
