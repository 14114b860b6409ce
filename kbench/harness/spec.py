"""Specs found by name: ``BENCHMARK.json``, a cell's workload file, its
configuration file, a part of ``kbench/parts/`` and a metric reader of
``kbench/metrics/``.  A later cell, configuration or metric is a new file;
nothing here names one."""

import importlib
import importlib.util
import json
import re
from pathlib import Path

import torch

KBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = KBENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
# the control's precision: the nearest below the configuration's
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def _named(name):
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(checkout=CHECKOUT):
    return _json(Path(checkout) / "BENCHMARK.json")


def workload(name, root=KBENCH):
    return _json(Path(root) / "workloads" / f"{_named(name)}.json")


def config(name, root=KBENCH):
    return _json(Path(root) / "configs" / f"{_named(name)}.json")


def part(name):
    return importlib.import_module(f"kbench.parts.{_named(name)}")


def metrics(bench, cell, section):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def reader(name):
    """The ``read`` function of ``kbench/metrics/<name>.py``."""
    path = KBENCH / "metrics" / f"{_named(name)}.py"
    module_spec = importlib.util.spec_from_file_location(f"kbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
