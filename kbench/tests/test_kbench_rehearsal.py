"""The harness rehearsed on the CPU: ``run.py``'s run of each cell on a
tiny copy of its workload file, the kernels' plain versions underneath.
The harness finds configurations, cells, parts and metric readers by
name, so a later cell or metric is a new file and no edit."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import krylov_tpu_torch as kt
from kbench.harness import cell, spec
from kbench.tests import tiny

kt.set_default_device("cpu")
CPU = torch.device("cpu")
CELLS = sorted(p.stem for p in (spec.KBENCH / "workloads").glob("*.json")
               if json.loads(p.read_text())["chips"] == 1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny")
    tiny.copy(path)
    return path


def _run(name, root, traced, seed=2**31 + 29):
    return cell.run_cell(name, seed, 0.3, traced, CPU, time.perf_counter(), root=root)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_its_end_to_end_metrics(name, root):
    line = _run(name, root, False)
    checks = line["checks"]
    bench = spec.benchmark()
    want = {m["name"] for m in spec.metrics(bench, name, "end_to_end")}
    assert set(line["metrics"]) == want
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(checks) == set(spec.workload(name)["limits"])
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reads_its_counter_metrics_when_traced(name, root):
    line = _run(name, root, True)
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.metrics(spec.benchmark(), name, "per_layer")}
    # the CPU has no device trace: the device metrics are left out
    device = {m["name"] for m in spec.benchmark()["per_layer"] if m["source"] == "device_trace"}
    assert set(line["metrics"]) == per_layer - device


def test_a_new_cell_is_a_new_file(root):
    wl = spec.workload("poisson2d_4096.cg", root)
    wl["tol"] = 1e-4
    (root / "workloads" / "poisson2d_4096.loose.json").write_text(json.dumps(wl))
    line = _run("poisson2d_4096.loose", root, False)
    assert line["metrics"]["solves_per_s"]["value"] > 0


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = spec.benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.stem for p in (spec.KBENCH / "metrics").glob("*.py") if p.stem != "__init__"}
    assert names == files
    for name in names:
        assert callable(spec.reader(name))


def test_names_are_refused_outside_the_pattern():
    for bad in ("../run", "a/b", "", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            spec.workload(bad)


def test_run_refuses_a_machine_without_the_card():
    out = subprocess.run([sys.executable, str(spec.KBENCH / "run.py"), "--workload",
                          "poisson2d_4096.cg", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout == ""
