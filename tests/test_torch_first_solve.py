"""A process's first solve on the ``while_loop`` graph route compiles nothing.

The graph route screens a step before its capture under dispatch modes of
its own (``_graphs.host_reads``; ``_graphs.storages_read`` for a built
solver).  ``TorchDispatchMode`` wraps a subclass's ``__torch_dispatch__``
in ``torch._disable_dynamo`` unless the class opts out, and the wrapper's
first call imports ``torch._dynamo`` with sympy: seconds of a fresh
process's first graph-route solve.  Each case runs in a fresh interpreter
on the CPU: a solve on the route's plain twin (``_driver._plain_graph``,
which screens and "captures" as the card's route does), and a built
solver's first run on a mesh of one process (``Mesh.of_one``), each held
bit for bit to its host-stepped run, with one capture and neither
``torch._dynamo`` nor ``sympy`` imported.
"""

import json
import subprocess
import sys

import pytest

# the solve's set-up and its two runs, host-stepped and on the plain twin;
# prints what they did and the modules imported
_SCRIPT = """
import json, sys
import numpy as np, torch
import krylov_tpu_torch as kt
from krylov_tpu_torch import _driver
from krylov_tpu_torch.ops import stencil as st
from krylov_tpu_torch.parallel import make_sharded_solver
from krylov_tpu_torch.parallel.mesh import Mesh

kt.set_default_device("cpu")
A = st.poisson_2d(16, 16)
b = torch.from_numpy(np.random.default_rng(7).standard_normal(256))
solver = getattr(kt, {solver!r})
kw = dict(tol=1e-12, atol=1e-4, maxiter=40, **{kw!r})
if {built!r}:
    solve = make_sharded_solver(solver, A, mesh=Mesh.of_one("cpu"), **kw)
    run = lambda: solve(b)[1]
else:
    run = lambda: solver(A, b, backend="while_loop", **kw)[1]
before = set(sys.modules)
with _driver._host_stepped():
    host = run()
_driver.reset_counts()
with _driver._plain_graph(3, 2, 2):
    graph = run()
print(json.dumps(dict(
    captures=_driver.COUNTS["captures"], kept=_driver.LAST_GRAPH.get("kept"),
    same=bool(host.numsteps == graph.numsteps and host.success == graph.success
              and np.array_equal(np.asarray(host.resnorms), np.asarray(graph.resnorms))
              and torch.equal(host.xk, graph.xk)),
    numsteps=int(graph.numsteps), imported=len(set(sys.modules) - before),
    compilers=sorted(m for m in ("torch._dynamo", "sympy") if m in sys.modules))))
"""

CASES = {
    "cg": ("cg", {}, False),
    "chebyshev": ("chebyshev", dict(eigenvalue_estimates=(0.03, 8.0)), False),
    "built_cg": ("cg", {}, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_first_graph_route_solve_imports_no_compiler(case):
    solver, kw, built = CASES[case]
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(solver=solver, kw=kw, built=built)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["compilers"] == [], got
    assert got["captures"] == 1 and got["numsteps"] > 3, got
    assert got["same"], got
    if built:
        assert got["kept"] == "captured", got
