"""The control and the program's readings of a cell, at its own size on
the card:

    python3 kbench/tests/control.py --cell <cell> --seeds 1 2 3 [--program port|control]

runs ``run_cell`` once a seed, in one process, the control being the plain
reference put in the port's place in the precision below the
configuration's, and prints each seed's compared numbers as a JSON line.
The limits of a workload file are set from these readings."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from kbench.harness import cell  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--program", choices=("port", "control"), default="control")
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        line = cell.run_cell(args.cell, seed, args.seconds, False, dev, t,
                             program=args.program)
        print(json.dumps({"cell": args.cell, "program": args.program, "seed": seed,
                          "attempted": line["attempted"], "correct": line["correct"],
                          "s": time.perf_counter() - t, "checks": line["checks"],
                          "readings": line["readings"]}),
              flush=True)


if __name__ == "__main__":
    main()
