"""The benchmark of ``krylov_tpu_torch`` on the card.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: the cell's
workload file ``kbench/workloads/<cell>.json`` names its configuration
(``kbench/configs/``), entry, solver, preconditioner, right-hand sides and
stop.  It sets the port up, warms it up on the cell's own shapes, runs the
closed loop for ``--seconds``, checks a sample of the answers against the
plain reference of ``kbench/reference/`` and prints one JSON line last on
standard output: the end-to-end metrics with ``--trace 0``, the per-layer
ones (each read by ``kbench/metrics/<name>.py``) with ``--trace 1``.  The
numbers compared, each beside its limit, are the last lines on standard
error.  Without a CUDA device, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed places inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}
THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "kbench" / "_cache" / sub)
    for var in THREADS:
        os.environ.setdefault(var, "4")
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from kbench.harness import cell, spec

    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    if int(wl["chips"]) != 1:
        print(f"{args.workload}: only one-chip cells are run here", file=sys.stderr)
        return 2
    try:
        line = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    except cell.ForbiddenModules as e:
        print(f"loaded in the measured process: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    report(line)
    return 0


def report(line):
    """Each number beside its limit as the last lines of standard error,
    then the result as the last line of standard output."""
    print("correct" if line["correct"] else "NOT correct", file=sys.stderr)
    for name, value in line["readings"].items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
