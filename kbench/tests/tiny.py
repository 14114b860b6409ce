"""Tiny copies of the benchmark's cells, for the CPU tests: each workload
and configuration file with its grid cut so that a run takes seconds on
the CPU; every other number as it stands."""

import json
from pathlib import Path

from kbench.harness import spec

GRIDS = {2: [64, 64], 3: [32, 32, 32]}  # 32^3 still holds 4 levels


def copy(root, cells=None):
    """Write the tiny copies under ``root`` (``workloads/``, ``configs/``);
    returns the cell names."""
    root = Path(root)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    names = cells or [p.stem for p in (spec.KBENCH / "workloads").glob("*.json")]
    for name in names:
        wl = spec.workload(name)
        if wl["chips"] != 1:
            continue
        cfg = spec.config(wl["config"])
        cfg["grid"] = GRIDS[len(cfg["grid"])]
        (root / "configs" / f"{wl['config']}.json").write_text(json.dumps(cfg))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return sorted(n for n in names if spec.workload(n)["chips"] == 1)
