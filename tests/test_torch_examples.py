"""The torch twins of ``examples/*.py`` run at toy sizes on the CPU.

Each ``examples/torch_*.py`` has a ``main(argv)`` that prints what its
reference example prints and returns the ``Info`` of each solve.  Here each
runs in this process with ``--device cpu`` at a small ``--n`` (its sharded
sections print that they were skipped: no process group of two or more
ranks), and the three with sharded sections run again on two gloo ranks of
a spawned world, where those sections run.  The problems are the reference
examples' own, so the port's single-device solves are held to the
reference's on the same problems where a reference solve is cheap.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu_torch.parallel import _spawn

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "examples")
sys.path.insert(0, EXAMPLES)  # the spawned ranks import the examples by name too

import torch_distributed_solve  # noqa: E402
import torch_multigrid_solve  # noqa: E402
import torch_poisson_solve  # noqa: E402
import torch_preconditioners  # noqa: E402
import torch_sparse_csr_solve  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def pool():
    with _spawn.SPMDPool(2, timeout=120.0) as p:
        yield p


def test_example_files_import_neither_jax_nor_the_reference():
    for name in sorted(os.listdir(EXAMPLES)):
        if name.startswith("torch_") and name.endswith(".py"):
            with open(os.path.join(EXAMPLES, name)) as f:
                src = f.read()
            for word in ("import jax", "from jax", "import krylov_tpu\n", "from krylov_tpu ",
                         "from krylov_tpu.", "import krylov_tpu.", "import krylov_tpu as"):
                assert word not in src, (name, word)


def test_poisson_example(capsys):
    out = torch_poisson_solve.main(["--n", "16"] + CPU)
    assert all(out[k].success for k in ("grid_cg", "fused_cg", "gmres"))
    printed = capsys.readouterr().out
    assert "grid CG:" in printed and "fused CG:" in printed and "GMRES(m):" in printed


def test_multigrid_example():
    out = torch_multigrid_solve.main(["--n", "16"] + CPU)
    assert out["mg"].success and out["galerkin"].success and out["amg"].success
    assert out["mg"].numsteps < out["plain"].numsteps and out["mg_levels"] == 3
    assert out["amg_levels"] == (256,)  # 256 rows stay under coarse_size: one dense level


def test_sparse_csr_example(capsys):
    out = torch_sparse_csr_solve.main(["--n", "2048"] + CPU)
    assert all(out[k].success for k in ("implicit", "cg", "bicgstab", "gauss_seidel"))
    assert "sharded section skipped" in capsys.readouterr().out
    # the implicit route takes the scipy matrix as the reference does
    A = torch_sparse_csr_solve.irregular_spd(2048)
    b = np.random.default_rng(1).standard_normal(2048).astype(np.float32)
    _, ref = krylov_tpu.cg(A, jnp.asarray(b), tol=1e-4, maxiter=200)
    assert abs(out["implicit"].numsteps - int(ref.numsteps)) <= 1


def test_preconditioners_example(capsys):
    out = torch_preconditioners.main(["--n", "16"] + CPU)
    assert out["block_jacobi"].numsteps < out["jacobi"].numsteps
    assert out["amg"].numsteps < out["plain"].numsteps
    assert out["gmres_ilu"].numsteps < out["gmres"].numsteps and out["bicgstab_ilu"].success
    assert "sharded section skipped" in capsys.readouterr().out


def test_distributed_example():
    out = torch_distributed_solve.main(["--n", "16"] + CPU)
    assert out["solve"].success and all(i.success for i in out["steps"])


def test_jacobi_preconditioner_of_a_scipy_matrix():
    """The examples pass scipy matrices to ``jacobi_preconditioner``, as the
    reference's do (the port raised on them): its diagonal goes to the
    default device."""
    A = torch_preconditioners.poisson2d(8, eps=100.0)
    A[3, 3] = 0.0  # a zero diagonal entry is guarded
    M = kt.jacobi_preconditioner(A)
    Mj = krylov_tpu.jacobi_preconditioner(A)
    x = np.random.default_rng(2).standard_normal(64)
    np.testing.assert_array_equal((M @ torch.as_tensor(x)).numpy(),
                                  np.asarray(Mj @ jnp.asarray(x)))
    assert kt.jacobi_preconditioner(scipy.sparse.eye(4).toarray()).d.device.type == "cpu"


@pytest.mark.parametrize("example,argv", [
    (torch_sparse_csr_solve, ["--n", "2048"]),
    (torch_preconditioners, ["--n", "16"]),
    (torch_distributed_solve, ["--n", "16"]),
])
def test_sharded_sections_on_two_ranks(pool, example, argv):
    """Under a process group of two ranks the sharded sections run."""
    out = pool.run(_spawn.main_job, example.__name__, argv + CPU)
    keys = {"torch_sparse_csr_solve": ["sharded"],
            "torch_preconditioners": ["sharded_amg", "sharded_ilu"],
            "torch_distributed_solve": ["solve"]}[example.__name__]
    for key in keys:
        assert out[key][0], key
    if example is torch_preconditioners:
        single = torch_preconditioners.main(argv + CPU)
        assert out["sharded_amg"][1] * 2 < single["plain"].numsteps
