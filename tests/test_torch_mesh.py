"""The mesh of krylov_tpu_torch.parallel: its transport, its reductions, the
shard monitor, process-group set-up and failure handling, on gloo ranks on
the CPU.

The transport and the ``psum_*`` contractions are held to the same
contractions in one process on the whole arrays, and
:class:`~krylov_tpu_torch._driver.ShardMonitor` to the reference's
contract.  A rank that raises or skips a collective must surface as an
error in the caller within the timeout, never as a hang.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.parallel import _spawn

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pools():
    with _spawn.SPMDPool(2, timeout=60.0) as two, _spawn.SPMDPool(4, timeout=60.0) as four:
        yield {2: two, 4: four}


def _arrays(n=16, K=3, k=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    V = rng.standard_normal((K, n)) + 1j * rng.standard_normal((K, n))
    U = rng.standard_normal((n, k))
    return x, y, V, U


@pytest.mark.parametrize("ranks", [2, 4])
def test_transport_at_the_mesh_edges(pools, ranks):
    """``shift`` moves a slab one rank along (zeros where nothing arrives,
    the reference's ppermute without wrap), ``all_gather_rows`` tiles the
    slabs in mesh order, ``reduce_scatter_rows`` sums and splits, complex
    data included."""
    x, y, V, U = _arrays()
    res = pools[ranks].run(_spawn.collectives_job, x, y, V, U)
    m = len(x) // ranks
    slabs = [x[i * m : (i + 1) * m] for i in range(ranks)]
    for i, per in enumerate(res["per_rank"]):
        np.testing.assert_array_equal(per["up"], slabs[i - 1] if i > 0 else 0 * slabs[0])
        np.testing.assert_array_equal(
            per["down"], slabs[i + 1] if i + 1 < ranks else 0 * slabs[0])
        np.testing.assert_allclose(per["scatter"],
                                   y[i * m : (i + 1) * m] * sum(range(1, ranks + 1)),
                                   rtol=1e-15)
    np.testing.assert_array_equal(res["gather"], x)
    np.testing.assert_array_equal(res["sum"], np.full(3, ranks * (ranks + 1) / 2))
    assert res["collectives"]["exchange"] == 2 and res["staged"]["exchange"] == 0


@pytest.mark.parametrize("ranks", [2, 4])
def test_psum_contractions_match_one_process(pools, ranks):
    """The four reductions against the single-process contractions of
    the port (``_inner``) and of the reference (``psum_*``'s einsums)."""
    x, y, V, U = _arrays(seed=ranks)
    res = pools[ranks].run(_spawn.collectives_job, x, y, V, U)
    np.testing.assert_allclose(res["inner"], np.vdot(x, y), rtol=1e-13)
    np.testing.assert_allclose(res["fused"][0], np.vdot(x, y), rtol=1e-13)
    np.testing.assert_allclose(res["fused"][1], np.vdot(y, y), rtol=1e-13)
    np.testing.assert_allclose(res["batch"], np.einsum("kn,n->k", V.conj(), y), rtol=1e-13)
    np.testing.assert_allclose(res["block"], U.T @ U, rtol=1e-13)
    want = kt._inner.get_default_inner(x.shape)(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(res["inner"], want.numpy(), rtol=1e-13)


@pytest.mark.parametrize("backend", ["eager", "while_loop"])
def test_shard_monitor_fires_on_rank_0_only(pools, backend):
    """``fn(k, resnorm)`` fires numsteps + 1 times, on rank 0 of the rows
    axis, with the reduced recurrence values, under both drivers; the same
    calls as the reference's monitor."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    b = np.random.default_rng(0).standard_normal((16, 16))
    res = pools[4].run(_spawn.monitor_job, kt.cg, At, b, backend=backend, tol=1e-8,
                       maxiter=300)
    counts = [len(p["calls"]) for p in res["per_rank"]]
    success, steps, hist = res["info"]
    assert success and counts == [steps + 1, 0, 0, 0]
    calls = res["per_rank"][0]["calls"]
    assert [k for k, _ in calls] == list(range(steps + 1))
    rn = np.array([float(r) for _, r in calls])
    np.testing.assert_array_equal(rn[:-1], hist[:-1])
    ref = []
    jpar.sharded_solve(krylov_tpu.cg, Aj, jnp.asarray(b), mesh=jpar.make_mesh(n_rows=4),
                       tol=1e-8, maxiter=300, callback=lambda k, r: ref.append(float(r)))
    np.testing.assert_allclose(sorted(rn), sorted(ref), rtol=1e-9)


def test_two_rank_workers_import_no_jax():
    """A 2-rank gloo solve started from a fresh interpreter: neither the
    caller nor any rank imports jax, krylov_tpu or triton."""
    code = textwrap.dedent("""
        import sys, numpy as np, krylov_tpu_torch as kt
        from krylov_tpu_torch.parallel import _spawn
        from krylov_tpu_torch.ops import stencil as st
        if __name__ == "__main__":
            kt.set_default_device("cpu")
            res = _spawn.run_spmd(_spawn.solve_job, 2, kt.cg, st.poisson_2d(8, 8),
                                  np.ones(64), tol=1e-10, maxiter=100, timeout=60)
            bad = [m for m in sys.modules if m.split(".")[0] in
                   ("jax", "jaxlib", "krylov_tpu", "triton")]
            print(res["info"][0], bad, [p["forbidden"] for p in res["per_rank"]])
            sys.exit(0 if res["info"][0] and not bad
                     and not any(p["forbidden"] for p in res["per_rank"]) else 1)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_initialize_from_the_environment():
    """``initialize()`` reads torchrun's variables; a second call is a
    no-op; ``global_mesh`` and ``process_info`` see a world of one; with
    no variables and no arguments nothing starts."""
    code = textwrap.dedent("""
        import torch.distributed as dist, krylov_tpu_torch as kt
        from krylov_tpu_torch.parallel import multihost
        kt.set_default_device("cpu")
        multihost.initialize()
        first = dist.group.WORLD
        multihost.initialize()
        mesh = multihost.global_mesh()
        print(dist.get_world_size(), dist.group.WORLD is first, mesh.shape,
              multihost.process_info()[:2], dist.get_backend())
    """)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "True", "{'rows':", "1,", "'rhs':", "1}", "(0,", "1)",
                                   "gloo"], proc.stdout
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    code = ("import torch.distributed as dist; from krylov_tpu_torch.parallel import multihost;"
            " multihost.initialize(); print(dist.is_initialized())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "False", proc.stderr


def test_make_mesh_with_no_group_starts_a_world_of_one():
    """``sharded_solve`` with no mesh and no process group: a world of one
    on gloo (the CPU), the single-device trajectory."""
    code = textwrap.dedent("""
        import numpy as np, torch, torch.distributed as dist, krylov_tpu_torch as kt
        from krylov_tpu_torch import parallel
        from krylov_tpu_torch.ops import stencil as st
        kt.set_default_device("cpu")
        A = st.poisson_2d(16, 16)
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(256))
        x, info = parallel.sharded_solve(kt.cg, A, b, tol=1e-10, maxiter=300)
        _, ref = kt.cg(A, b, tol=1e-10, maxiter=300, backend="while_loop")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert info.numsteps == ref.numsteps, (info.numsteps, ref.numsteps)
        np.testing.assert_allclose(info.resnorms, ref.resnorms, rtol=1e-12)
        np.testing.assert_allclose(x.numpy(), ref.xk.numpy(), rtol=1e-12, atol=1e-14)
        try:
            parallel.make_mesh(n_rows=2)
        except ValueError as e:
            print("refused:", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "needs 2 ranks, have 1" in proc.stdout


@pytest.mark.parametrize("fault", ["raise", "skip"])
def test_a_diverging_rank_fails_the_call_within_the_timeout(pools, fault):
    """A rank that raises, or that skips a collective the others wait in,
    surfaces as an error in the caller, within the groups' timeout; the
    pool stops every rank and starts afresh for the next job."""
    x, y, V, U = _arrays()
    t0 = time.monotonic()
    with pytest.raises((_spawn.SPMDError, TimeoutError)):
        pools[4].run(_spawn.collectives_job, x, y, V, U, group_timeout=3.0,
                     **{f"{fault}_rank": 1})
    assert time.monotonic() - t0 < 30  # the groups' timeout, not the job's (60 s)
    res = pools[4].run(_spawn.collectives_job, x, y, V, U)
    np.testing.assert_array_equal(res["gather"], x)
