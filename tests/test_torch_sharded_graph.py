"""The sharded solves on the ``while_loop`` graph route, on the CPU.

Four gloo ranks of one module-scoped pool run each sharded case of
``tests/test_torch_parallel.py``'s kinds twice (``_spawn.graph_job``): on
the host-stepped loop, then on the graph route's plain twin
(``_driver._plain_graph``: every IF node's flag read on the host), whose
guarded steps run the same collectives.  The two runs agree bit for bit
(iterate, step count, history) and launch the same collectives, and the
route's run is held to the reference's sharded solve on four virtual
devices at ``test_torch_parallel.py``'s tolerances.  Then the ranks'
agreement: costs that differ by rank, a host read on one rank, a capture
that fails on one rank; and a rank alone on its mesh, which launches no
collective.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu_torch as kt
from krylov_tpu import parallel as jpar
from krylov_tpu.ops import bsr as jbsr
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import _driver
from krylov_tpu_torch import parallel as tpar
from krylov_tpu_torch.ops import bsr as tbsr
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.parallel import _spawn
from krylov_tpu_torch.parallel import mesh as pm
from tests.test_torch_parallel import (  # noqa: F401
    F32_RTOL, RANKS, _block_dense, _pet_matrix, held, pool, ref_solve,
)

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

PLAN = ("plain", 3, 2, 2)  # three host steps, then graphs of two steps, two replays a read


def _rng(seed):
    return np.random.default_rng(seed)


def graph_solve(pool, solver, A, b, n_rhs=1, route=PLAN, **kw):
    return pool.submit(_spawn.graph_job, getattr(kt, solver), A, b, route=route,
                       mesh_rows=RANKS // n_rhs, mesh_rhs=n_rhs, **kw)


def on_both(res, captures=1):
    """The route's run bit-equal to the host-stepped one on every rank,
    with the same collectives; the route captured on every rank.  Returns
    the route's result in ``held``'s form."""
    res = res.result()
    assert res["error"] is None, res["error"]
    (x_host, x_graph), (i_host, i_graph) = res["x"], res["info"]
    assert i_graph[0] == i_host[0] and i_graph[1] == i_host[1]
    np.testing.assert_array_equal(i_graph[2], i_host[2])
    np.testing.assert_array_equal(x_graph, x_host)
    for p in res["per_rank"]:
        assert p["collectives"][1] == p["collectives"][0], p["collectives"]
        assert p["driver"]["host_stepped"] == 0 and p["driver"]["captures"] == captures, \
            p["driver"]
        assert p["driver"]["graph_steps"] > 0 and not p["forbidden"]
    return {"x": x_graph, "info": i_graph, "per_rank": res["per_rank"]}


# ---------------------------------------------------------------------------
# every sharded kind, host-stepped against the plain graph route
# ---------------------------------------------------------------------------


def _csr_gather():
    rng = _rng(5)
    Q = rng.standard_normal((64, 64))
    dense = Q @ Q.T + 64 * np.eye(64)
    dense[np.abs(dense) < 1.0] = 0.0
    sp = scipy.sparse.csr_matrix((dense + dense.T) / 2)
    assert tpar.partition_csr(sp, RANKS)["mode"] == "gather"
    return sp, rng.standard_normal(64)


def _case(name):
    """``(solver, port operator, reference operator, b, keywords, rtol,
    x_rtol)`` of one sharded kind."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    if name == "grid_M_diag":
        d = np.asarray(At.diagonal())
        return "cg", At, Aj, _rng(13).standard_normal((16, 16)), dict(
            M_diag=1.0 / d, tol=1e-10, maxiter=300), 1e-9, 1e-8
    if name == "const":
        return ("cg", tst.poisson_2d_const(16, 12), jst.poisson_2d_const(16, 12),
                _rng(14).standard_normal((16, 12)), dict(tol=1e-10, maxiter=600), 1e-9, 1e-8)
    if name == "csr_halo":
        sp = scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(64, 64), format="csr")
        assert tpar.partition_csr(sp, RANKS)["mode"] == "halo"
        return "cg", sp, sp, _rng(4).standard_normal(64), dict(tol=1e-12, maxiter=200), \
            1e-9, 1e-8
    if name == "csr_gather":
        sp, b = _csr_gather()
        return "cg", sp, sp, b, dict(tol=1e-12, maxiter=300), 1e-9, 1e-8
    if name == "pet":
        A, rng = _pet_matrix()
        return ("cg", tpar.partition_pet(A, RANKS), jpar.partition_pet(A, RANKS),
                rng.standard_normal(1024).astype(np.float32), dict(tol=1e-4, maxiter=200),
                F32_RTOL, F32_RTOL)
    if name == "bsr":
        dense, rng = _block_dense()
        sp = scipy.sparse.csr_matrix(dense)
        return ("cg", tbsr.BSROperator.from_scipy(sp, blocksize=(32, 32)),
                jbsr.BSROperator.from_scipy(sp, blocksize=(32, 32)), rng.standard_normal(512),
                dict(tol=1e-10, maxiter=400), 1e-9, 1e-8)
    if name == "cg_pipelined":
        return "cg_pipelined", At, Aj, _rng(7).standard_normal((256, 2)), dict(
            tol=1e-8, maxiter=300), 1e-9, 1e-8
    if name == "cg_block":
        return "cg_block", At, Aj, _rng(3).standard_normal((256, 3)), dict(
            tol=1e-8, maxiter=300), 1e-9, 1e-8
    if name == "gmres_cgs":
        return "gmres", At, Aj, _rng(7).standard_normal(256), dict(
            ortho="cgs", tol=1e-10, maxiter=80), 1e-9, 1e-8
    raise KeyError(name)


@pytest.mark.parametrize("name", ["grid_M_diag", "const", "csr_halo", "csr_gather", "pet", "bsr",
                                  "cg_pipelined", "cg_block", "gmres_cgs"])
def test_a_sharded_kind_on_the_graph_route(pool, name):
    solver, At, Aj, b, kw, rtol, x_rtol = _case(name)
    job = graph_solve(pool, solver, At, b, **kw)
    ref = ref_solve(solver, Aj, b, **kw)
    held(on_both(job), ref, rtol=rtol, x_rtol=x_rtol)


def test_make_sharded_solver_keeps_one_capture(pool):
    """Three right-hand sides through one built solver: the first run
    captures the graph the solver keeps, the later ones replay it from
    step 0 (the reference compiles its solver once), and each run agrees
    bit for bit with the host-stepped one and with the reference's
    solve."""
    Aj, At = jst.poisson_2d(16, 16), tst.poisson_2d(16, 16)
    bs = [_rng(s).standard_normal(256) for s in (1, 2, 3)]
    res = graph_solve(pool, "cg", At, bs, build=True, tol=1e-10, maxiter=300).result()
    assert res["error"] is None, res["error"]
    (xs_host, xs_graph), (is_host, is_graph) = res["x"], res["info"]
    for j, b in enumerate(bs):
        assert is_graph[j][1] == is_host[j][1]
        np.testing.assert_array_equal(is_graph[j][2], is_host[j][2])
        np.testing.assert_array_equal(xs_graph[j], xs_host[j])
        held({"x": xs_graph[j], "info": is_graph[j]}, ref_solve("cg", Aj, b, tol=1e-10,
                                                               maxiter=300))
    assert all(p["driver"]["captures"] == 1 and p["driver"]["host_stepped"] == 0
               and p["driver"]["kept_runs"] == 2 and p["driver"]["host_steps"] == PLAN[1]
               for p in res["per_rank"])


def test_a_two_by_two_mesh_agrees_over_its_rows_only(pool):
    """``shard_rhs`` on a 2 x 2 mesh: each rhs shard solves its own column
    and may stop at its own step; the ranks of each rows group agree."""
    Aj, At = jst.poisson_2d(8, 8), tst.poisson_2d(8, 8)
    b = _rng(8).standard_normal((64, 2))
    kw = dict(shard_rhs=True, tol=1e-10, maxiter=200)
    job = graph_solve(pool, "cg", At, b, n_rhs=2, **kw)
    ref = ref_solve("cg", Aj, b, n_rhs=2, **kw)
    res = held(on_both(job), ref)
    assert res["info"][2].shape[1:] == (2,)


# ---------------------------------------------------------------------------
# the ranks' agreement
# ---------------------------------------------------------------------------


def test_costs_that_differ_by_rank_give_one_plan(pool):
    """Rank 0's own costs say no capture repays (a host step of 0.1 us),
    the others' that one does: every rank plans with the largest costs,
    so every rank captures the same plan, and nothing waits."""
    At = tst.poisson_2d(16, 16)
    b = _rng(21).standard_normal(256)
    host_s = (1e-7, 1e-2, 1e-2, 1e-2)
    assert _driver._plan(_driver.Costs(40, host_s[0], 1e-6, 0.0, 0.0, 0.0)) is None
    assert _driver._plan(_driver.Costs(40, host_s[1], 1e-6, 0.0, 0.0, 0.0)) is not None
    res = on_both(graph_solve(pool, "cg", At, b, route=("rule", host_s), tol=1e-10,
                              maxiter=300))
    plans = [p["plan"] for p in res["per_rank"]]
    assert plans[0] is not None and all(p == plans[0] for p in plans), plans
    assert all(p["driver"]["meetings"] == res["per_rank"][0]["driver"]["meetings"] > 0
               for p in res["per_rank"])


def test_a_host_read_on_one_rank_keeps_every_rank_on_the_host_loop(pool):
    At = tst.poisson_2d(16, 16)
    b = _rng(22).standard_normal(256)
    res = graph_solve(pool, "cg", At, b, read_rank=2, tol=1e-10, maxiter=300).result()
    assert res["error"] is None
    (x_host, x_graph), (i_host, i_graph) = res["x"], res["info"]
    np.testing.assert_array_equal(x_graph, x_host)
    np.testing.assert_array_equal(i_graph[2], i_host[2])
    for p in res["per_rank"]:
        d = p["driver"]
        assert d["uncapturable"] == 1 and d["captures"] == 0 and d["graph_steps"] == 0, d


def test_a_capture_that_fails_on_one_rank_raises_on_all(pool):
    At = tst.poisson_2d(16, 16)
    b = _rng(23).standard_normal(256)
    res = graph_solve(pool, "cg", At, b, fail_rank=1, tol=1e-10, maxiter=300).result()
    errors = [p["error"] for p in res["per_rank"]]
    assert "rank 1's capture fails on purpose" in errors[1], errors
    for i in (0, 2, 3):
        assert "rank 1 of this sharded solve failed to capture" in errors[i], errors
    assert all(p["driver"]["graph_steps"] == 0 for p in res["per_rank"])


# ---------------------------------------------------------------------------
# a rank alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["grid", "csr", "cg_pipelined"])
def test_a_rank_alone_launches_no_collective(kind):
    """A world of one gloo rank in this process: the mesh launches nothing
    (``mesh.COUNTS`` stays all zeros) on either route, the graph route's
    plain twin captures, and both runs are bit-equal to the single-device
    solve, which had no collectives to skip."""
    import torch.distributed as dist

    A = tst.poisson_2d(16, 16)
    b = torch.as_tensor(_rng(30).standard_normal((16, 16)))
    solver, kw, single_kw = kt.cg, dict(tol=1e-10, maxiter=300), {}
    if kind in ("csr", "cg_pipelined"):
        A = scipy.sparse.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(64, 64), format="csr")
        b = torch.as_tensor(_rng(31).standard_normal(64))
        solver = kt.cg_pipelined if kind == "cg_pipelined" else kt.cg
    else:
        single_kw = dict(inner=lambda u, v: torch.sum(u.conj() * v, dim=(0, 1)))
    mesh = tpar.make_mesh(device="cpu")
    try:
        infos = []
        for ctx in (_driver._host_stepped(), _driver._plain_graph(3, 2, 2)):
            pm.reset_counts()
            _driver.reset_counts()
            with ctx:
                infos.append(tpar.sharded_solve(solver, A, b, mesh=mesh, **kw)[1])
            assert all(v == 0 for v in pm.COUNTS.values()), pm.COUNTS
            assert _driver.COUNTS["meetings"] == 0
        assert _driver.COUNTS["captures"] == 1 and _driver.COUNTS["graph_steps"] > 0
    finally:
        dist.destroy_process_group()
    op = A if kind == "grid" else kt.ops.sparse.CSROperator.from_scipy(A)
    single = solver(op, b, backend="while_loop", **kw, **single_kw)[1]
    for info in infos:
        assert info.numsteps == single.numsteps
        np.testing.assert_array_equal(info.resnorms, single.resnorms)
        torch.testing.assert_close(info.xk, single.xk, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the weak-scaling twin
# ---------------------------------------------------------------------------


def test_the_weak_scaling_twin_runs_on_gloo_ranks(tmp_path):
    """``tools/torch_weak_scaling.py --device cpu --small`` under torchrun
    on two gloo ranks: one JSON line a route, the reference's keys, every
    solve the fixed number of steps."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         os.path.join(root, "tools", "torch_weak_scaling.py"), "--device", "cpu", "--small",
         "--repeats", "1"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]
    assert [d["route"] for d in lines] == ["host", "rule"], proc.stdout
    for d in lines:
        assert {"metric", "solver", "operator", "devices", "processes", "n_rows", "nnz", "iters",
                "s_per_iter", "nnz_per_s", "nnz_per_s_per_device", "card"} <= set(d)
        assert d["devices"] == 2 and d["n_rows"] == 2 * 4096 and d["iters"] == 20
        assert d["s_per_iter"] > 0 and not d["captured"]  # the CPU runs the host loop
