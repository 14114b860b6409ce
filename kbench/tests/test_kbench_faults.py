"""The check sees a broken timed path: the rest of a run (tiny copies of the
cells, on the CPU, no look for a chip) with a fault planted in the port
underneath, and ``correct`` comes out false.  The faults a solve can have:
a step that returns its state unchanged, half of the right-hand sides left
unsolved, an answer altered where it is produced.  (No cell here spans
chips, so none leaves out an exchange between them.)  The unbroken run
comes out correct."""

import importlib
import time
from unittest import mock

import pytest
import torch

import krylov_tpu_torch as kt
from kbench.harness import cell
from kbench.tests import tiny

kt.set_default_device("cpu")
cg_module = importlib.import_module("krylov_tpu_torch.solvers.cg")
CELLS = ["poisson2d_4096.cg", "hpcg_27pt.mgcg", "poisson2d_4096.mgcg8"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny")
    tiny.copy(path, CELLS)
    return path


def _run(name, root):
    line = cell.run_cell(name, 2**31 + 101, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), root=root)
    return line["correct"], line["checks"]


def _stalled_step():
    real = cg_module.run

    def run(state0, method, **kw):
        return real(state0, method._replace(step=lambda s, criterion, ctl: s), **kw)

    return mock.patch.object(cg_module, "run", run)


def _altered_answer(alter):
    real = kt.cg

    def cg(A, b, **kw):
        sol, info = real(A, b, **kw)
        x = info.xk.clone()
        alter(x)
        return (None if sol is None else x), info._replace(xk=x)

    return mock.patch.object(kt, "cg", cg)


def _half_left_out(x):
    if x.ndim == 2:
        x[:, x.shape[1] // 2:] = 0  # half of the columns
    else:
        x[x.shape[0] // 2:] = 0  # half of the unknowns of the one column


def _one_entry(x):
    x.view(-1)[x.numel() // 3] += 1.0


FAULTS = {"unchanged state": _stalled_step,
          "half the right-hand sides": lambda: _altered_answer(_half_left_out),
          "an altered answer": lambda: _altered_answer(_one_entry)}


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_run_is_correct(name, root):
    ok, checks = _run(name, root)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_incorrect(name, fault, root):
    with FAULTS[fault]():
        ok, checks = _run(name, root)
    assert not ok, checks
