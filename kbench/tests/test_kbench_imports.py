"""Nothing the harness runs loads JAX or the JAX package: every module in
the process after a run has a top-level name (the part before the first
dot) other than ``jax``, ``jaxlib``, ``flax`` and ``krylov_tpu``, compared
whole, so the port ``krylov_tpu_torch`` passes."""

import ast
import json
import subprocess
import sys

from kbench.harness import cell, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "krylov_tpu"}

PROBE = """
import json, sys, time
sys.path.insert(0, {repo!r})
import torch
import krylov_tpu_torch as kt
kt.set_default_device("cpu")
from kbench.harness import cell
from kbench.tests import tiny
tiny.copy({root!r}, ["poisson2d_4096.mgcg8"])
cell.run_cell("poisson2d_4096.mgcg8", 7, 0.2, True, torch.device("cpu"), time.perf_counter(),
              root=__import__("pathlib").Path({root!r}))
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax(tmp_path):
    code = PROBE.format(repo=str(spec.CHECKOUT), root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in names}
    assert not tops & FORBIDDEN
    assert "krylov_tpu_torch" in tops  # the port: its name begins with the JAX package's


def test_no_harness_file_imports_jax():
    for path in spec.KBENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "krylov_tpu_torch_other", sys.modules[__name__])
    assert cell.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "krylov_tpu.solvers", sys.modules[__name__])
    assert cell.loaded_forbidden() == ["krylov_tpu"]
