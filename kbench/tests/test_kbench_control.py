"""The control comes out not correct: the plain reference put in the port's
place and computed in the precision below the configuration's (bfloat16
for float32, float32 for float64) fails a limit of its cell.  On the CPU
at the tiny sizes; on the card at each cell's own size, three seeds
(``python -m pytest kbench/tests/test_kbench_control.py -m cuda``)."""

import time

import pytest
import torch

import krylov_tpu_torch as kt
from kbench.harness import cell
from kbench.tests import tiny

kt.set_default_device("cpu")
CELLS = ["poisson2d_4096.cg", "hpcg_27pt.mgcg", "poisson2d_4096.mgcg8"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny")
    tiny.copy(path, CELLS)
    return path


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_tiny_size(name, root):
    line = cell.run_cell(name, 2**31 + 3, 0.1, False, torch.device("cpu"),
                         time.perf_counter(), root=root, program="control")
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        line = cell.run_cell(name, seed, 1.0, False, torch.device("cuda", 0),
                             time.perf_counter(), program="control")
        assert not line["correct"], line["checks"]
