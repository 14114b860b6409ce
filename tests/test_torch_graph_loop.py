"""The ``while_loop`` driver's graph route, on the CPU.

On a CUDA device a ``while_loop`` solve of a capturable method measures its
first steps and, when :func:`krylov_tpu_torch._driver._plan` says a
captured graph repays its capture, replays one CUDA graph of IF-guarded
steps (``krylov_tpu_torch._driver``).  Here, without a device,
``_driver._plain_graph()`` runs the same guarded-step body with each IF
node's flag read on the host: the graph route's plain twin.  It is held bit
for bit to the host-stepped loop (``_run_while``: history, ``numsteps``,
``success``, iterate) for every solver and preconditioner marked
capturable, with a solve cut by ``maxiter``, one whose explicit recheck
fails and resumes the same graph, an early exit, a complex Hermitian solve,
a bfloat16 PET operator whose state changes types over its first steps,
and graphs of a step count that does not divide the solve's.  Each solve is
held to ``krylov_tpu``'s own ``while_loop`` in float64 at
``tests/test_torch_cg.py``'s band (resnorms rtol 1e-10 with atol 1e-14 r0,
iterates rtol 1e-9 with atol 1e-12); the bfloat16 case, whose reference
rounds ``x`` to bfloat16 in its selection pass as well, within 2e-2 of the
reference's recurrence resnorms, bfloat16 rounding, over the steps both
take.  The
reference runs compiled, its multigrid and AMG cycles eagerly, as its own
tests run them (a compiled MG-CG costs ~18 s), each solve once
(``functools.cache``).  The cost rule is checked as a pure function fed
synthetic costs and through the twin, the route decision before any step,
and ``ensure_real`` under a capture.
"""

import functools
from typing import NamedTuple
from unittest import mock

from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu.ops import stencil as js
from krylov_tpu_torch import _driver, _graphs, _inner
from krylov_tpu_torch._driver import Costs
from krylov_tpu_torch.ops import stencil as ts

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

RTOL, XTOL = 1e-10, 1e-9  # tests/test_torch_cg.py's float64 band
BF16_RTOL = 2e-2  # bfloat16 rounding of the operator's values and of x


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(np.geomspace(1.0, cond, n)) @ Q.T, rng.standard_normal(n)


def _hpd(n, cond, seed):
    """A complex Hermitian positive definite matrix and a complex b."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return (Q @ np.diag(np.geomspace(1.0, cond, n)) @ Q.conj().T,
            rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _shifted_poisson(g, shift=0.5):
    return scipy.sparse.diags([-1.0, -1.0, 4.0 + shift, -1.0, -1.0], [-g, -1, 0, 1, g],
                              shape=(g * g, g * g), format="csr")


def _bf16_pet():
    """A bfloat16 PET operator of both packages on a shifted Poisson (its
    products are float32: ``cg``'s bfloat16 state changes types over its
    first two steps) and a bfloat16 b."""
    from krylov_tpu.ops import pallas_spmv
    from krylov_tpu_torch.ops.cuda_spmv import PETOperator

    lap = _shifted_poisson(24).astype(np.float32)
    b = np.random.default_rng(8).standard_normal(lap.shape[0]).astype(np.float32)
    At = PETOperator.from_scipy(lap, data_dtype=torch.bfloat16, with_rmatvec=False,
                                device="cpu")
    Aj = pallas_spmv.PETOperator.from_scipy(lap, interpret=True, data_dtype=jnp.bfloat16,
                                            with_rmatvec=False)
    return At, Aj, b


def _case(name):
    """``(port solve, reference solve)`` of one case, each returning
    ``(x, info)``; float64 but for the bfloat16 case."""
    wl = dict(backend="while_loop")
    if name in ("cg", "cg M", "cg maxiter", "cg recheck fails"):
        # the recurrence dips below 3e-16 and the explicit residual does not
        # follow: a failed recheck at every step after, to maxiter
        A, b = _spd(200, 10.0, 1) if name == "cg recheck fails" else _spd(100, 10.0, 1)
        At, bt = torch.from_numpy(A), torch.from_numpy(b)
        d = 1.0 / np.diag(A)
        kw = {"cg": dict(tol=1e-10),
              "cg M": dict(tol=1e-10),
              "cg maxiter": dict(tol=1e-12, maxiter=13),
              "cg recheck fails": dict(tol=3e-16, atol=0.0, maxiter=77)}[name]
        if name == "cg M":
            return (lambda: kt.cg(At, bt, M=kt.DiagonalOperator(torch.from_numpy(d)), **kw, **wl),
                    lambda: krylov_tpu.cg(A, b, M=krylov_tpu.DiagonalOperator(jnp.asarray(d)),
                                          **kw, **wl))
        return lambda: kt.cg(At, bt, **kw, **wl), lambda: krylov_tpu.cg(A, b, **kw, **wl)
    if name in ("cg complex", "minres complex"):
        A, b = _hpd(100, 10.0, 9)  # the size and spectrum of the real "cg" case
        solver_t, solver_j = getattr(kt, name.split()[0]), getattr(krylov_tpu, name.split()[0])
        return (lambda: solver_t(torch.from_numpy(A), torch.from_numpy(b), tol=1e-10, **wl),
                lambda: solver_j(A, b, tol=1e-10, **wl))
    if name in ("cg_stencil", "cg_stencil fused"):
        At, Aj = ts.poisson_2d_const(14, 11, dtype=np.float64), js.poisson_2d_const(
            14, 11, dtype=np.float64)
        b = np.random.default_rng(2).standard_normal((14, 11))
        fused = name.endswith("fused")
        return (lambda: kt.cg_stencil(At, torch.from_numpy(b), tol=1e-10, fused=fused),
                lambda: krylov_tpu.cg_stencil(Aj, jnp.asarray(b), tol=1e-10))
    if name == "bicgstab early":
        # Ml = diag(A)^-1: the mid-step probe ends the solve (early_success)
        A = _shifted_poisson(17)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        d = 1.0 / A.diagonal()
        return (lambda: kt.bicgstab(A, b, Ml=kt.DiagonalOperator(torch.from_numpy(d)),
                                    tol=1e-8, **wl),
                lambda: krylov_tpu.bicgstab(A, b, Ml=krylov_tpu.DiagonalOperator(
                    jnp.asarray(d)), tol=1e-8, **wl))
    if name in ("qmr", "minres", "bicg", "cgs", "lsqr", "cgnr", "richardson", "jacobi"):
        # the normal equations square the condition number: a larger shift
        # keeps lsqr's and cgnr's float64 trajectories within the band
        A = _shifted_poisson(9, shift=4.0 if name in ("lsqr", "cgnr") else 0.5)
        if name in ("qmr", "bicg", "cgs", "lsqr", "cgnr"):  # nonsymmetric
            A = A + scipy.sparse.diags([0.1, -0.1], [1, -1], shape=(81, 81))
        A = A.tocsr()
        b = np.random.default_rng(3).standard_normal(81)
        kw = dict(tol=1e-10)
        if name in ("richardson", "jacobi"):
            kw = dict(tol=1e-10, omega=0.2 if name == "richardson" else 0.9, maxiter=60)
        solver_t, solver_j = getattr(kt, name), getattr(krylov_tpu, name)
        return (lambda: solver_t(A, b, **kw, **wl), lambda: solver_j(A, b, **kw, **wl))
    if name == "cg + multigrid":
        At, Aj = ts.poisson_2d_const(8, dtype=np.float64), js.poisson_2d_const(
            8, dtype=np.float64)
        b = np.random.default_rng(4).standard_normal((8, 8))
        Mt, Mj = kt.MultigridPreconditioner(At), krylov_tpu.MultigridPreconditioner(Aj)
        return (lambda: kt.cg(At, torch.from_numpy(b), M=Mt, inner=lambda u, v: torch.sum(u * v),
                              tol=1e-10, maxiter=30, **wl),
                lambda: krylov_tpu.cg(Aj, jnp.asarray(b), M=Mj,
                                      inner=lambda u, v: jnp.sum(u * v), tol=1e-10, maxiter=30))
    if name == "cg + amg":
        A = _shifted_poisson(32, shift=0.0)
        b = np.random.default_rng(5).standard_normal(A.shape[0])
        Mt, Mj = kt.AMGPreconditioner.from_scipy(A), krylov_tpu.AMGPreconditioner.from_scipy(A)
        return (lambda: kt.cg(A, b, M=Mt, tol=1e-10, maxiter=60, **wl),
                lambda: krylov_tpu.cg(A, b, M=Mj, tol=1e-10, maxiter=60))
    if name in COUNTED:
        return _counted_case(name)
    if name == "cg bf16":
        At, Aj, b = _bf16_pet()
        bt = torch.from_numpy(b).bfloat16()
        return (lambda: kt.cg(At, bt, tol=1e-2, maxiter=40, **wl),
                lambda: krylov_tpu.cg(Aj, jnp.asarray(b, jnp.bfloat16), tol=1e-2, maxiter=40,
                                      **wl))
    raise KeyError(name)


def _counted_case(name):
    """The methods whose step depends on its step number
    (``Method.counted``): a shifted Poisson of 81 rows, made nonsymmetric
    for the nonsymmetric solvers (symmlq: an SPD matrix of 8); the
    replacements of ``cg_pipelined`` and ``cg_block`` fire every 5 and 4
    steps, inside the twin's replays; a ``gmres`` cut by ``maxiter`` and
    restarted."""
    wl = dict(backend="while_loop")
    solver = name.split()[0]
    A = _shifted_poisson(9)
    if solver in ("tfqmr", "gcr", "gmres"):
        A = (A + scipy.sparse.diags([0.1, -0.1], [1, -1], shape=(81, 81))).tocsr()
    b = np.random.default_rng(11).standard_normal(81)
    kw = dict(tol=1e-10)
    if name.endswith(" M"):
        d = 1.0 / A.diagonal()
        Mt, Mj = kt.DiagonalOperator(torch.from_numpy(d)), krylov_tpu.DiagonalOperator(
            jnp.asarray(d))
    kw_t, kw_j = dict(kw), dict(kw)
    if name.endswith(" M"):
        kw_t["M"], kw_j["M"] = Mt, Mj
    if solver == "chebyshev":
        # the Poisson's spectrum: 4.5 -+ 4 cos(pi / 10)
        bounds = (4.5 - 4 * np.cos(np.pi / 10), 4.5 + 4 * np.cos(np.pi / 10))
        kw_t["eigenvalue_estimates"] = kw_j["eigenvalue_estimates"] = bounds
    elif name == "symmlq":
        # its reported norm (of the Lanczos vector) vanishes only once the
        # Krylov space is exhausted (tests/test_torch_symmetric.py)
        A, b = _spd(8, 10.0, 13)
        kw_t["tol"] = kw_j["tol"] = 1e-8
    elif name == "cg arnoldi":
        kw_t["return_arnoldi"] = kw_j["return_arnoldi"] = True
    elif solver == "cg_pipelined":
        kw_t["replace_every"] = kw_j["replace_every"] = 5
    elif solver == "cg_block":
        b = np.random.default_rng(12).standard_normal((81, 3))
        kw_t["replace_every"] = kw_j["replace_every"] = 4
    elif solver == "gmres":
        ortho = {"gmres mgs": "mgs", "gmres mgs2 M": "mgs2", "gmres cgs": "cgs",
                 "gmres householder": "householder", "gmres restart cut": "mgs"}[name]
        kw_t["ortho"] = kw_j["ortho"] = ortho
        if name == "gmres restart cut":
            for k_ in (kw_t, kw_j):
                k_.update(restart=7, maxiter=26)
    solver_t, solver_j = getattr(kt, solver), getattr(krylov_tpu, solver)
    return (lambda: solver_t(A, b, **kw_t, **wl), lambda: solver_j(A, b, **kw_j, **wl))


COUNTED = ("cgr", "chebyshev", "symmlq", "tfqmr M", "cg arnoldi", "cg_pipelined replace",
           "cg_block replace", "gcr", "gmres mgs", "gmres mgs2 M", "gmres cgs",
           "gmres householder", "gmres restart cut")
CASES = ("cg", "cg M", "cg maxiter", "cg recheck fails", "cg complex", "cg_stencil",
         "cg_stencil fused", "bicgstab early", "qmr", "minres", "minres complex", "bicg", "cgs",
         "lsqr", "cgnr", "richardson", "jacobi", "cg + multigrid", "cg + amg",
         "cg bf16") + COUNTED


@pytest.fixture(autouse=True)
def _pet_on_the_cpu(monkeypatch):
    """The bfloat16 case's PET route, rehearsed on the CPU."""
    from krylov_tpu_torch import _operators

    monkeypatch.setattr(_operators, "_pet_device", lambda device: True)


@functools.cache
def _reference(name):
    x, info = _case(name)[1]()
    return (None if x is None else np.asarray(x)), info


def _routes(name, plan=(2, 2, 2)):
    """The host-stepped and the plain graph route's ``(x, info)`` of one
    case, and the driver's counts of the graph solve."""
    solve = _case(name)[0]
    with _driver._host_stepped():
        ref = solve()
    _driver.reset_counts()
    with _driver._plain_graph(*plan):
        got = solve()
    return ref, got, dict(_driver.COUNTS)


def _bit_equal(got, ref):
    assert got.numsteps == ref.numsteps and got.success == ref.success
    np.testing.assert_array_equal(got.resnorms, ref.resnorms)
    assert torch.equal(got.xk, ref.xk)
    if getattr(ref, "arnoldi", None) is not None:  # cg's return_arnoldi: V, H, P
        V, H, P = got.arnoldi
        V0, H0, P0 = ref.arnoldi
        np.testing.assert_array_equal(H, H0)
        assert all(torch.equal(a, c) for a, c in zip(V + P, V0 + P0, strict=True))


@pytest.mark.parametrize("name", CASES)
def test_plain_graph_is_bit_equal_to_the_host_stepped_loop(name):
    (x_h, host), (x_g, graph), counts = _routes(name)
    runs = -(-26 // 7) if name == "gmres restart cut" else 1  # a run a GMRES(7) cycle
    assert counts["graph_route"] == runs and counts["host_stepped"] == 0
    assert counts["captures"] == runs  # the twin's graph, made once a run
    steps = counts["host_steps"] + counts["graph_steps"]
    assert steps == graph.numsteps + ("bicgstab" in name and graph.success)
    _bit_equal(graph, host)
    assert (x_g is None) == (x_h is None)


@pytest.mark.parametrize("name", ("cg", "cg recheck fails", "cg_stencil fused",
                                  "bicgstab early", "minres", "cg bf16"))
@pytest.mark.parametrize("plan", [(2, 3, 1), (3, 8, 4), (5, 5, 3)])
def test_graphs_of_steps_that_do_not_divide_the_solve(name, plan):
    """Graphs of 3, 8 and 5 steps (steps ending anywhere in a replay), as
    many host steps before, several replays a read of the flag: the same
    trajectory.  The fused cg_stencil ping-pongs its direction and takes an
    even count only: 8 of its 3 and 5."""
    if name == "cg_stencil fused" and plan[1] % 2:
        plan = (plan[0], 8, plan[2])
    (_, host), (_, graph), counts = _routes(name, plan)
    assert counts["graph_route"] == 1 and counts["captures"] == 1
    _bit_equal(graph, host)
    assert counts["replays"] <= plan[2] * (counts["flag_reads"] - counts["host_steps"])


@pytest.mark.parametrize("name", CASES)
def test_plain_graph_matches_the_reference_while_loop(name):
    _, (x, info), _ = _routes(name)
    xj, ref = _reference(name)
    want = np.asarray(ref.resnorms, dtype=np.float64)
    if name == "cg bf16":
        assert info.success == bool(ref.success) and abs(info.numsteps - int(ref.numsteps)) <= 2
        # the recurrence's entries; the last entry is each package's explicit
        # residual, below the criterion in both
        n = min(info.numsteps, int(ref.numsteps))
        np.testing.assert_allclose(info.resnorms[:n], want[:n], rtol=BF16_RTOL)
        return
    assert info.success == bool(ref.success) and info.numsteps == int(ref.numsteps)
    np.testing.assert_allclose(info.resnorms, want, rtol=RTOL,
                               atol=1e-14 * np.max(np.abs(want[0])))
    np.testing.assert_allclose(info.xk.numpy(), np.asarray(ref.xk), rtol=XTOL, atol=1e-12)
    assert (x is None) == (xj is None)


def _variant(name):
    """A counted method on a complex or blocked right-hand side, or with a
    user inner product or split preconditioners: a 40-row matrix of the
    spectrum of the "cg" case (complex Hermitian, or real tridiagonal)."""
    rng = np.random.default_rng(14)
    Hz, bz = (torch.from_numpy(a) for a in _hpd(40, 10.0, 15))
    Nz = Hz + 0.3 * torch.diag(torch.ones(39, dtype=Hz.dtype), 1)  # nonnormal
    A = torch.from_numpy(np.diag(np.geomspace(1.0, 10.0, 40)) + 0.2 * (
        np.eye(40, k=1) + np.eye(40, k=-1)))
    B = torch.from_numpy(rng.standard_normal((40, 3)))
    b = B[:, 0].contiguous()
    D = kt.DiagonalOperator(1.0 / torch.diagonal(A))
    wl = dict(tol=1e-10, backend="while_loop")
    # 45 steps of a 46-row basis: CGS's second chunk runs past the basis
    # and starts over rows of the first
    W = torch.from_numpy(np.diag(np.geomspace(1.0, 1e3, 120)) + 0.2 * (
        np.eye(120, k=1) - np.eye(120, k=-1)))
    w = torch.from_numpy(rng.standard_normal(120))
    return {
        "gmres cgs past a chunk": lambda: kt.gmres(W, w, ortho="cgs", maxiter=45, **wl),
        "gmres cgs past a chunk, a user inner": lambda: kt.gmres(
            W, w, ortho="cgs", maxiter=45, inner=lambda u, v: torch.sum(u * v), **wl),
        "gmres mgs complex": lambda: kt.gmres(Nz, bz, **wl),
        "gmres cgs complex": lambda: kt.gmres(Nz, bz, ortho="cgs", **wl),
        "gmres householder complex": lambda: kt.gmres(Nz, bz, ortho="householder", **wl),
        "gmres mgs (N, 3)": lambda: kt.gmres(A, B, **wl),
        "gmres cgs3 (N, 3)": lambda: kt.gmres(A, B, ortho="cgs3", **wl),
        "gmres householder (N, 3)": lambda: kt.gmres(A, B, ortho="householder", **wl),
        "gmres cgs, a user inner": lambda: kt.gmres(A, b, ortho="cgs",
                                                    inner=lambda u, v: torch.sum(u * v), **wl),
        "gmres Ml, Mr": lambda: kt.gmres(A, b, Ml=D, Mr=kt.DiagonalOperator(
            torch.full((40,), 0.5, dtype=torch.float64)), **wl),
        "gmres householder restarted": lambda: kt.gmres(A, b, ortho="householder", restart=5,
                                                        maxiter=33, **wl),
        "cg arnoldi (N, 3)": lambda: kt.cg(A, B, return_arnoldi=True, **wl),
        "cg arnoldi complex": lambda: kt.cg(Hz, bz, return_arnoldi=True, **wl),
        "tfqmr complex": lambda: kt.tfqmr(Nz, bz, **wl),
        "tfqmr (N, 3)": lambda: kt.tfqmr(A, B, **wl),
        "chebyshev (N, 3)": lambda: kt.chebyshev(A, B, (0.6, 10.5), maxiter=300, **wl),
        "cg_pipelined complex": lambda: kt.cg_pipelined(Hz, bz, replace_every=3, **wl),
        "cg_block complex": lambda: kt.cg_block(Hz, torch.stack([bz, bz.conj()], 1),
                                                replace_every=3, **wl),
        "gcr (N, 3)": lambda: kt.gcr(A, B, **wl),
        "gcr M": lambda: kt.gcr(A, b, M=D, **wl),
    }[name]


@pytest.mark.parametrize("name", [
    "gmres mgs complex", "gmres cgs complex", "gmres householder complex", "gmres mgs (N, 3)",
    "gmres cgs3 (N, 3)", "gmres householder (N, 3)", "gmres cgs, a user inner", "gmres Ml, Mr",
    "gmres householder restarted", "cg arnoldi (N, 3)", "cg arnoldi complex", "tfqmr complex",
    "tfqmr (N, 3)", "chebyshev (N, 3)", "cg_pipelined complex", "cg_block complex", "gcr (N, 3)",
    "gcr M", "gmres cgs past a chunk", "gmres cgs past a chunk, a user inner"])
def test_plain_graph_of_counted_variants_is_bit_equal_to_the_host_stepped_loop(name):
    """The counted methods' device forms (``torch.where`` over complex and
    blocked states, ``index_copy_`` into tails of right-hand-side columns,
    a user inner product in CGS's chunks, a chunk past the basis) on the
    twin, bit for bit the host-stepped loop's, with graphs of 3 and of 1
    step."""
    solve = _variant(name)
    with _driver._host_stepped():
        _, host = solve()
    for plan in ((2, 3, 2), (3, 1, 5)):
        _driver.reset_counts()
        with _driver._plain_graph(*plan):
            _, graph = solve()
        assert _driver.COUNTS["captures"] >= 1
        _bit_equal(graph, host)


def test_the_cases_reach_what_they_are_for():
    """The cut, the failed rechecks that resume the same graph, the early
    exit, the state's types changing in the bfloat16 case."""
    runs = {}
    for name in ("cg maxiter", "cg recheck fails", "bicgstab early", "cg bf16"):
        _driver.reset_counts()
        with _driver._plain_graph():
            _, info = _case(name)[0]()
        runs[name] = (info, dict(_driver.COUNTS), dict(_driver.LAST_GRAPH))
    info, _, _ = runs["cg maxiter"]
    assert info.numsteps == 13 and not info.success
    info, c, _ = runs["cg recheck fails"]
    assert info.numsteps == 77 and not info.success and c["rechecks"] > 2
    assert c["captures"] == 1  # each failed recheck resumes the same graph's replays
    info, c, _ = runs["bicgstab early"]
    assert info.success and c["rechecks"] == 0  # the early exit skips the recheck
    info, c, last = runs["cg bf16"]
    # two steps change the state's types; the host steps until one has not
    assert last["host_steps"] == 4 and c["captures"] == 1 and info.xk.dtype == torch.float32


class _Early:
    """A synthetic capturable method whose step ``early_at`` exits early."""

    def __init__(self, early_at):
        self.early_at = early_at

    def method(self):
        def step(s, criterion):
            x = s.x + 1
            early = x == self.early_at
            return type(s)(x, s.resnorm * 0.5 + 0.01 * x, early)

        return _driver.Method(step=step, xk=lambda s: s.x, capturable=True)


class _S(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor
    early_success: torch.Tensor


@pytest.mark.parametrize("early_at,maxiter", [(3, 20), (11, 20), (9, 9), (-1, 19)])
def test_plain_graph_early_exit_and_cut_on_a_synthetic_method(early_at, maxiter):
    """The early step overwrites the last history entry (nothing appended)
    wherever it falls in a replay, as the host-stepped loop does."""
    s0 = _S(torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64),
            torch.tensor(False))
    method = _Early(float(early_at)).method()
    runs = []
    for ctx in (_driver._host_stepped(), _driver._plain_graph(2, 3, 2)):
        with ctx:
            runs.append(_driver.run(s0, method, tol=1e-30, atol=0.0, maxiter=maxiter,
                                    backend="while_loop"))
    (sh, okh, kh, hh), (sg, okg, kg, hg) = runs
    assert (okg, kg) == (okh, kh) and torch.equal(sg.x, sh.x)
    np.testing.assert_array_equal(hg, hh)
    assert kg == (early_at - 1 if 0 < early_at <= maxiter else maxiter)


# --- the cost rule ----------------------------------------------------------------


def _costs(**kw):
    base = dict(steps_left=100, host_s=1.0e-3, launch_s=1.0e-4, device_s=0.9e-3,
                copy_s=5e-5, clone_s=5e-5)
    return Costs(**{**base, **kw})


def test_plan_keeps_cheap_host_gaps_on_the_host():
    # the host adds 20 us a step to 980 us of device work: nothing to win
    assert _driver._plan(_costs(host_s=1.0e-3, device_s=0.98e-3)) is None
    # dear host gaps, but a capture as dear as what the few steps left save
    assert _driver._plan(_costs(steps_left=5, host_s=2e-3, launch_s=3e-3,
                                device_s=0.3e-3)) is None
    # dear gaps, steps left to repay them, but a step no cheaper on the device
    assert _driver._plan(_costs(host_s=2e-3, device_s=2e-3)) is None


def test_plan_captures_where_the_host_gap_is_dear():
    # cg + Jacobi on a 1M-row CSR: ~350 us a step from the host, ~90 us of
    # kernels, 1500 steps
    U, R = _driver._plan(_costs(steps_left=1498, host_s=350e-6, launch_s=300e-6,
                                device_s=90e-6, copy_s=4 * 6.5e-6, clone_s=4 * 6.5e-6))
    assert U >= 2 and U * R <= _driver.STEPS_PER_READ
    # qmr + Jacobi on the same matrix: 18 steps, ~1.6 ms of host, ~0.3 ms of kernels
    assert _driver._plan(_costs(steps_left=16, host_s=1.6e-3, launch_s=1.4e-3,
                                device_s=0.3e-3, copy_s=30e-6, clone_s=60e-6)) is not None
    # the fused CG ping-pongs its direction: an even number of steps a graph
    U, _ = _driver._plan(_costs(steps_left=98, host_s=550e-6, launch_s=80e-6,
                                device_s=380e-6, even=True))
    assert U % 2 == 0
    # more steps a graph amortize a replay's copies back (generic cg at 4096^2)
    U_cheap, _ = _driver._plan(_costs(steps_left=98, host_s=1e-3, launch_s=1e-4,
                                      device_s=0.6e-3, copy_s=1e-6))
    U_dear, _ = _driver._plan(_costs(steps_left=98, host_s=1e-3, launch_s=1e-4,
                                     device_s=0.6e-3, copy_s=240e-6))
    assert U_dear > U_cheap


def test_plan_reads_the_flag_at_most_once_per_steps_left():
    U, R = _driver._plan(_costs(steps_left=12, host_s=2e-3, launch_s=2e-4, device_s=2e-4))
    assert U * R <= 12 or R == 1


@pytest.mark.parametrize("history,criterion,maxiter,want", [
    ([1.0, 0.5, 0.25], 1e-3, 100, 8),  # halving: 2^-10 < 1e-3
    ([1.0, 0.5, 0.25], 0.0, 100, 98),  # tol 0: every step to maxiter
    ([1.0, 1.2, 1.5], 1e-3, 50, 48),  # not shrinking
    ([1.0, 0.5, 0.25], 1e-30, 30, 28),  # capped by maxiter
    ([1.0, 0.1, 0.01], 0.02, 100, 0),  # below already
    ([[1.0, 1.0], [0.5, 0.1], [0.25, 0.01]], [1e-3, 1e-3], 100, 8),  # the slowest column
])
def test_steps_left_from_the_residuals_rate(history, criterion, maxiter, want):
    h = np.asarray(history, dtype=np.float64).reshape(len(history), -1)
    crit = np.resize(np.asarray(criterion, dtype=np.float64), h.shape[1])
    assert _driver._steps_left(h.T.tolist(), crit.tolist(), maxiter - len(history) + 1) == want


def _rule_solve(costs, first=3, tol=1e-10):
    """A ``cg`` solve on the twin (~36 steps at ``tol`` 1e-10) with the rule
    fed ``costs``, its first decision after step ``first``."""
    A, b = _spd(100, 10.0, 1)
    _driver.reset_counts()
    with mock.patch.object(_driver, "FIRST_CHECK", first), _driver._plain_graph(costs=costs):
        _, info = kt.cg(torch.from_numpy(A), torch.from_numpy(b), tol=tol,
                        backend="while_loop")
    return info, dict(_driver.COUNTS), dict(_driver.LAST_GRAPH)


def test_a_solve_shorter_than_the_first_decision_is_the_host_loops():
    """With the rule's own first decision (after step 24), a solve of
    fewer steps decides nothing, notes nothing and holds nothing, however
    dear its host steps."""
    info, c, last = _rule_solve(lambda left: _costs(steps_left=left, host_s=2e-3,
                                                    device_s=0.2e-3),
                                first=_driver.FIRST_CHECK, tol=1e-5)
    assert 10 < info.numsteps < _driver.FIRST_CHECK
    assert last["decisions"] == [] and c["held_steps"] == c["captures"] == 0
    assert c["host_steps"] == c["flag_reads"] == info.numsteps


def test_the_rule_holds_nothing_where_even_an_idle_device_would_not_repay():
    """A short solve of cheap host steps: at step 3 not even a device that
    took no time would repay a capture, so no step is held and the solve
    is the host-stepped loop's; the next decision would follow when the
    step count has doubled or the estimate of the steps left has run out,
    whichever comes later."""
    info, c, last = _rule_solve(lambda left: _costs(steps_left=left, host_s=1e-4,
                                                    launch_s=0.9e-4, device_s=0.5e-4))
    assert c["captures"] == c["held_steps"] == 0 and c["host_steps"] == info.numsteps > 8
    assert last["plan"] is None and last["decisions"][0][0] == 3
    for (k, costs, plan), (k2, _, _) in zip(last["decisions"], last["decisions"][1:]):
        assert plan is None and costs.device_s == 0.0 and k2 == max(2 * k, k + costs.steps_left)
    k, costs, _ = last["decisions"][0]  # the estimate within 2x of the steps that followed
    assert 0.5 * (info.numsteps - k) <= costs.steps_left <= 2 * (info.numsteps - k)
    _, host = kt.cg(*(torch.from_numpy(a) for a in _spd(100, 10.0, 1)), tol=1e-10,
                    backend="while_loop")
    _bit_equal(info, host)


def test_the_rule_keeps_a_solve_with_cheap_gaps_host_stepped():
    """Host steps that an idle device would make worth a capture: step 4 is
    held to time its device work, and that leaves nothing to win, at any
    step count up to maxiter: no later decision, no capture."""
    info, c, last = _rule_solve(lambda left: _costs(steps_left=left, host_s=1.0e-3,
                                                    device_s=0.99e-3))
    assert c["captures"] == 0 and c["host_steps"] == info.numsteps > 8
    assert c["held_steps"] == last["held_steps"] == 1
    (k0, screen, plan0), (k1, held, plan1) = last["decisions"]
    assert (k0, k1) == (3, 4) and plan0 is not None and plan1 is None
    assert screen.device_s == 0.0 and held.device_s == 0.99e-3
    _, host = kt.cg(*(torch.from_numpy(a) for a in _spd(100, 10.0, 1)), tol=1e-10,
                    backend="while_loop")
    _bit_equal(info, host)


def test_the_rule_captures_after_the_first_decision_when_gaps_are_dear():
    """The first decision follows step 3 and could repay at no device time;
    step 4 is held to time its device work, the decision after it repays;
    the rehearsal is step 5; the graph takes the rest."""
    info, c, last = _rule_solve(lambda left: _costs(steps_left=left, host_s=2e-3,
                                                    device_s=0.2e-3))
    assert c["captures"] == 1 and last["host_steps"] == 5 and c["held_steps"] == 1
    assert c["host_steps"] == 5 and c["graph_steps"] == info.numsteps - 5
    (k0, screen, _), (k, costs, plan) = last["decisions"]
    assert (k0, k) == (3, 4) and screen.device_s == 0.0 and costs.device_s == 0.2e-3
    assert costs.steps_left > 10 and last["plan"] == plan == _driver._plan(costs)


@pytest.mark.parametrize("share", [None, 1.0])
def test_the_rule_holds_a_step_only_where_that_costs_little(monkeypatch, share):
    """Dear host gaps a capture would repay at no device time, but a hold
    (about a step's launch time, 0.9 ms) dearer than MEASURE_SHARE of the
    ~30 ms still to go: no step is held and nothing captured; with a
    larger share the hold is paid and the capture taken."""
    if share is not None:
        monkeypatch.setattr(_driver, "MEASURE_SHARE", share)
    info, c, last = _rule_solve(lambda left: _costs(steps_left=left, host_s=1e-3,
                                                    launch_s=0.9e-3, device_s=0.1e-3))
    assert last["decisions"][0][2] is not None  # the decision at no device time
    if share is None:
        assert c["held_steps"] == c["captures"] == 0 and c["host_steps"] == info.numsteps
    else:
        assert c["held_steps"] == c["captures"] == 1 and last["host_steps"] == 5


def test_the_rule_decides_again_at_steps_6_and_12():
    """Costs that repay a capture only from the third decision on, each
    before it expecting the solve to end within two steps: decisions at 3,
    6 and 12, step 13 held to time its device work and decided after,
    rehearsed at 14, captured after it (the held step's device time is the
    costs' fifth call)."""
    seen = []

    def costs(left):
        seen.append(left)
        if len(seen) < 3:
            return _costs(steps_left=2, host_s=1e-3, device_s=1e-3)
        return _costs(steps_left=left, host_s=2e-3, device_s=0.2e-3)

    info, c, last = _rule_solve(costs)
    assert [k for k, _, _ in last["decisions"]] == [3, 6, 12, 13]
    assert len(seen) == 5 and c["captures"] == 1 and last["host_steps"] == 14


@pytest.mark.parametrize("name,value,costs", [
    # the capture repays 1.5x its cost: enough at PAYBACK 1, not at 2
    ("PAYBACK", 1.0, dict(steps_left=16, host_s=1e-3, launch_s=1e-4, device_s=0.6e-3)),
    # dear only by its base
    ("CAPTURE_BASE_S", 0.0, dict(steps_left=13, host_s=1e-3, launch_s=1e-4, device_s=0.6e-3)),
    # dear by its steps' Python: 1.8x with it, 2.5x without
    ("CAPTURE_PER_LAUNCH", 0.0, dict(steps_left=17, host_s=1.5e-3, launch_s=1.4e-3,
                                     device_s=0.9e-3)),
    # a host gap of 9 us a step, 5 of them the guard's: 1.3x, 3.0x without
    ("GUARD_S", 0.0, dict(steps_left=1000, host_s=1.009e-3, launch_s=1e-5, device_s=1e-3,
                          copy_s=0.0, clone_s=0.0)),
])
def test_each_constant_of_the_rule_moves_a_decision(monkeypatch, name, value, costs):
    c = _costs(**costs)
    assert _driver._plan(c) is None
    monkeypatch.setattr(_driver, name, value)
    assert _driver._plan(c) is not None


def test_the_copies_back_choose_the_steps_a_graph():
    """What copying the fields a step moves costs: a launch a field and its
    bytes twice; four 64 MiB fields make a graph of more steps worth it."""
    small, big = torch.zeros(4), torch.zeros(16 * 2**20)
    assert _driver._copy_s([small] * 4) == pytest.approx(4 * _driver.COPY_LAUNCH_S, rel=1e-3)
    copy = _driver._copy_s([big] * 4)
    assert copy == pytest.approx(4 * (_driver.COPY_LAUNCH_S + 2 * big.nbytes
                                      / _driver.COPY_BYTES_PER_S))
    base = dict(steps_left=98, host_s=1e-3, launch_s=1e-4, device_s=0.6e-3)
    U_small, _ = _driver._plan(_costs(**base, copy_s=_driver._copy_s([small] * 4)))
    U_big, _ = _driver._plan(_costs(**base, copy_s=copy))
    assert U_big > U_small


# --- the route, decided before any step -------------------------------------------------


def _counts_of(solve):
    _driver.reset_counts()
    solve()
    return dict(_driver.COUNTS)


def test_cpu_solves_take_the_host_stepped_loop():
    A, b = _spd(20, 10.0, 6)
    c = _counts_of(lambda: kt.cg(A, b, backend="while_loop"))
    assert c["host_stepped"] == 1 and c["graph_route"] == 0
    c = _counts_of(lambda: kt.cg(A, b, backend="eager"))
    assert c["host_stepped"] == c["graph_route"] == 0 and c["host_steps"] > 0


def test_the_route_is_decided_before_any_step():
    """Under the twin's switch, a callback, a ``ShardMonitor``, a method
    that is not capturable (a triangular sweep) and a state that requires
    a gradient still run the host-stepped loop, and ``fgmres`` its own host
    loop, as the reference's eager-only form does; the solvers
    whose step depends on its step number (``return_arnoldi``, ``tfqmr``,
    ``symmlq``, ``cg_pipelined``, ``gcr``, ``chebyshev``) take the graph
    route; ``_host_stepped()`` overrides the switch."""
    A, b = _spd(20, 10.0, 7)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    calls = []
    host = [
        lambda: kt.cg(A, b, callback=lambda *a: calls.append(1), backend="while_loop"),
        lambda: kt.cg(A, b, callback=_driver.ShardMonitor(lambda k, r: calls.append(k)),
                      backend="while_loop"),
        lambda: kt.cg(At, bt.clone().requires_grad_(), backend="while_loop"),
        lambda: kt.gauss_seidel(A, b, maxiter=5, backend="while_loop"),
    ]
    graph = [
        lambda: kt.cg(A, b, backend="while_loop"),
        lambda: kt.cg(A, b, return_arnoldi=True, backend="while_loop"),
        lambda: kt.tfqmr(A, b, backend="while_loop"),
        lambda: kt.symmlq(A, b, backend="while_loop"),
        lambda: kt.cg_pipelined(A, b, backend="while_loop"),
        lambda: kt.gcr(A, b, backend="while_loop"),
        lambda: kt.chebyshev(A, b, (1.0, 10.0), backend="while_loop", maxiter=5),
    ]
    with _driver._plain_graph():
        for solve in host:
            c = _counts_of(solve)
            assert c["host_stepped"] == 1 and c["graph_route"] == 0, c
        c = _counts_of(lambda: kt.fgmres(A, b, maxiter=5))
        assert c["graph_route"] == c["captures"] == 0, c
        for solve in graph:
            c = _counts_of(solve)
            assert c["graph_route"] == 1 and c["host_stepped"] == 0, c
        with _driver._host_stepped():
            c = _counts_of(lambda: kt.cg(A, b, backend="while_loop"))
        assert c["host_stepped"] == 1 and c["graph_route"] == 0
    assert calls
    # the rule itself: the CPU is never captured, whatever is forced
    method = _driver.Method(step=None, xk=None, capturable=True)
    s0 = _S(torch.zeros(()), torch.ones(()), torch.tensor(False))
    with _driver._capture_at():
        assert _driver._route(s0, method, None) == ("host", None)
    assert _driver._route(s0, method._replace(capturable=False), None) == ("host", None)
    assert _driver._route(s0, method, print) == ("host", None)


def test_a_one_rank_sharded_solve_takes_the_host_stepped_loop():
    """``sharded_solve`` on a world of one gloo rank takes the graph route
    (its plain twin here) where a single-device solve would, launching no
    collective; it takes the host-stepped loop with a ``ShardMonitor``
    callback, and on a staged mesh (gloo carrying CUDA tensors), whose
    every transfer goes through the host."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.parallel import mesh as pm
    from krylov_tpu_torch.parallel.solve import _graph_ranks as graph_ranks

    A = ts.poisson_2d(16, dtype=np.float64, device="cpu")
    b = torch.ones(A.grid, dtype=torch.float64)
    mesh = parallel.make_mesh(device="cpu")
    try:
        with _driver._plain_graph():
            pm.reset_counts()
            c = _counts_of(lambda: parallel.sharded_solve(kt.cg, A, b, mesh=mesh, tol=1e-8))
            assert not any(pm.COUNTS.values()), pm.COUNTS
            monitored = _counts_of(lambda: parallel.sharded_solve(
                kt.cg, A, b, mesh=mesh, tol=1e-8, callback=lambda k, rn: None))
    finally:
        dist.destroy_process_group()
    assert c["graph_route"] == c["captures"] == 1 and c["host_stepped"] == 0, c
    assert c["meetings"] == 0, c  # a rank alone meets no one
    assert monitored["host_stepped"] == 1 and monitored["graph_route"] == 0, monitored
    method = _driver.Method(step=None, xk=None, capturable=True)
    s0 = _S(torch.zeros(()), torch.ones(()), torch.tensor(False))
    staged = pm.Mesh.of_one("cpu")
    staged.staged = True
    with _driver._plain_graph():
        with graph_ranks(pm.Mesh.of_one("cpu")):
            assert _driver._route(s0, method, None)[0] == "plain"
        with graph_ranks(staged):
            assert _driver._route(s0, method, None) == ("host", None)


# --- the pieces under a capture ---------------------------------------------------------


@pytest.mark.parametrize("counter,limit", [(0, 5), (3, 4), (2, 9), (4, 4), (6, 2)])
def test_the_plain_loop_runs_its_body_limit_minus_counter_times(counter, limit):
    """``_graphs.host_loop`` (a WHILE node's plain twin): ``fn`` sees the
    counter at each of ``limit - counter`` runs (none from a counter at or
    past the limit), and the counter ends at the limit."""
    c = torch.tensor(counter, dtype=torch.int64)
    seen = []
    _graphs.host_loop(c, torch.tensor(limit, dtype=torch.int64), lambda j: seen.append(int(j)))
    assert seen == list(range(counter, limit))
    assert int(c) == max(counter, limit)


class _Once:
    """Guards that run each IF and WHILE body once, as a capture records
    it: what they record does not depend on the flags."""

    def __call__(self, flag, expect, fn):
        return fn()

    def loop(self, counter, limit, fn):
        fn(counter)

    def sibling(self, pred, fn):
        fn()


class _Ops(TorchDispatchMode):
    """The operations dispatched within but views (on the card, the
    kernels a capture records)."""

    def __init__(self):
        super().__init__()
        self.ops, self.shapes = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func._schema.name)
            self.shapes.append(tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))
        return func(*args, **(kwargs or {}))


class _Caught(Exception):
    pass


def _recorded_step(name, maxiter, k=5, host=False):
    """The operations step ``k`` of a solve records, with each sweep's body
    recorded once (:class:`_Once`), at ``maxiter``; with ``host``, the
    operations the host-stepped loop's step ``k`` dispatches."""
    from krylov_tpu_torch._steps import DeviceStep, HostStep

    A = _shifted_poisson(9) + scipy.sparse.diags([0.1, -0.1], [1, -1], shape=(81, 81))
    b = np.random.default_rng(13).standard_normal(81)
    module = "gcr" if name == "gcr" else "gmres"
    solve = getattr(kt, module)
    kw = {} if name == "gcr" else dict(ortho=name.split()[1].rstrip(","))
    if name.endswith("a user inner"):
        kw["inner"] = lambda u, v: torch.sum(u * v)

    def caught(state0, method, **_):
        raise _Caught(state0, method)

    with mock.patch(f"krylov_tpu_torch.solvers.{module}.run", caught):
        with pytest.raises(_Caught) as exc:
            solve(A.tocsr(), b, maxiter=maxiter, backend="while_loop", **kw)
    state0, method = exc.value.args
    ctl = HostStep(k) if host else DeviceStep(torch.tensor(k), _Once())
    with _Ops() as rec:
        method.step(state0, state0.resnorm, ctl)
    return list(zip(rec.ops, rec.shapes)) if host else rec.ops


@pytest.mark.parametrize("name", ["gmres mgs", "gmres cgs", "gmres householder", "gcr",
                                  "gmres cgs, a user inner"])
def test_a_recorded_step_does_not_grow_with_maxiter(name):
    """A captured step of each masked sweep records the same operations at
    maxiter 40 and 400: its sweeps are WHILE nodes (cgs: a loop over chunks
    of a fixed number of rows, each contracted by the user's inner row by
    row), not maxiter-long unrolled loops."""
    ops40, ops400 = _recorded_step(name, 40), _recorded_step(name, 400)
    assert len(ops40) == len(ops400) and ops40 == ops400
    assert len(_recorded_step(name, 40, k=30)) == len(ops40)  # nor with the step's number


# the operations that reduce over the basis's rows: the Euclidean batched
# contraction and combination (``mv``), a user inner's ``sum``
_REDUCTIONS = ("aten::mv", "aten::mm", "aten::bmm", "aten::dot", "aten::vdot", "aten::sum")


@pytest.mark.parametrize("name", ["gmres cgs", "gmres cgs, a user inner"])
@pytest.mark.parametrize("k", [5, 35])
def test_a_host_cgs_step_reduces_the_same_at_any_maxiter(name, k):
    """The host-stepped loop's CGS step launches the same reductions, of
    the same shapes, at maxiter 40 and 400: one contraction and one
    combination for each chunk of ``gmres.CGS_ROWS`` rows that holds rows
    0..k (for a user inner, one inner product a row of those chunks),
    however long the basis; at maxiter 80 and 400, where no chunk runs
    past the basis, the very same operations."""

    def reductions(ops):
        return [(op, shapes) for op, shapes in ops if op in _REDUCTIONS]

    ops40, ops80, ops400 = (_recorded_step(name, m, k=k, host=True) for m in (40, 80, 400))
    assert reductions(ops40) == reductions(ops400)
    assert [op for op, _ in ops80] == [op for op, _ in ops400]


def test_ensure_real_skips_its_check_while_capturing(monkeypatch):
    bad = torch.tensor(1.0 + 1.0j, dtype=torch.complex128)
    with pytest.raises(ValueError, match="imaginary"):
        _inner.ensure_real(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert _inner.ensure_real(bad) == 1.0


def test_ensure_real_skips_its_check_in_the_rehearsal_step():
    """The step the graph route runs from the host just before its capture
    reads nothing on the host either, so a complex solve's rehearsal does
    not synchronize; the check is back once it is done."""
    bad = torch.tensor(1.0 + 1.0j, dtype=torch.complex128)
    with _inner.host_checks_off():
        with _inner.host_checks_off():
            assert _inner.ensure_real(bad) == 1.0
        assert _inner.ensure_real(bad) == 1.0
    with pytest.raises(ValueError, match="imaginary"):
        _inner.ensure_real(bad)


def test_host_reads_notes_this_threads_reads_only():
    """The rehearsal's watch: a scalar read, a boolean-mask index and a copy
    from the host are noted, arithmetic is not, and another thread's reads
    are not seen."""
    import threading

    x = torch.arange(4.0)
    other = []
    with _graphs.host_reads("cpu") as seen:
        y = x * 2.0 + 1.0
        assert not seen
        t = threading.Thread(target=lambda: other.append(float(x.sum())))
        t.start()
        t.join()
        assert not seen and other == [6.0]
        bool(y.sum() > 0)
        y[y > 2]
    assert [op.split(" ")[0] for op in seen] == ["aten::_local_scalar_dense", "aten::index"]
    with _graphs.host_reads("cuda") as seen:
        float(x.sum())  # a CPU value, not the watched device's
    assert not seen


def _host_inner(u, v):
    return torch.sum(u * v) * float(u.abs().max() > 0)


@pytest.mark.parametrize("route", ["forced", "rule"])
def test_a_step_that_reads_the_host_stays_on_the_host_loop(route):
    """An ``inner`` that reads a value on the host: the rehearsal step
    before the capture notes it, and the rest of the solve runs
    host-stepped, every time, nothing captured and nothing rerun: the
    host-stepped loop's trajectory bit for bit."""
    A, b = _spd(100, 10.0, 1)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def solve():
        return kt.cg(At, bt, inner=_host_inner, tol=1e-10, backend="while_loop")

    with _driver._host_stepped():
        _, ref = solve()
    plan = ((3, 2, 2, None) if route == "forced" else
            (2, 2, 2, lambda left: _costs(steps_left=left, host_s=2e-3, device_s=0.2e-3)))
    for _ in range(2):
        _driver.reset_counts()
        with _driver._plain_graph(*plan):
            _, info = solve()
        c, last = dict(_driver.COUNTS), dict(_driver.LAST_GRAPH)
        assert c["graph_route"] == c["uncapturable"] == 1 and c["captures"] == 0, c
        assert c["host_steps"] == info.numsteps and "_local_scalar_dense" in last["uncapturable"]
        _bit_equal(info, ref)


class _X(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor


def test_a_conditional_body_that_reads_the_host_stays_on_the_host_loop():
    """A counted step whose IF body, due at step 49 only, reads the host:
    the rehearsal's host form never runs it, the screen of the device form
    runs every body once and notes the read, and the solve stays
    host-stepped, before any capture, bit for bit the host-stepped loop."""

    def step(s, criterion, ctl):
        x = s.x + 1
        ctl.cond(ctl.k == 49, lambda: x.add_(float(x) * 0.0))
        return _X(x, s.resnorm * 0.5)

    method = _driver.Method(step=step, xk=lambda s, k: s.x, capturable=True, counted=True)
    s0 = _X(torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
    with _driver._host_stepped():
        _, _, k_host, hist_host = _driver.run(s0, method, tol=1e-30, atol=0.0, maxiter=30,
                                              backend="while_loop")
    _driver.reset_counts()
    with _driver._plain_graph(3, 2, 2):
        state, _, k, hist = _driver.run(s0, method, tol=1e-30, atol=0.0, maxiter=30,
                                        backend="while_loop")
    c, last = dict(_driver.COUNTS), dict(_driver.LAST_GRAPH)
    assert c["uncapturable"] == 1 and c["captures"] == 0, c
    assert "_local_scalar_dense" in last["uncapturable"] and c["host_steps"] == 30
    assert k == k_host == 30 and float(state.x) == 30.0
    np.testing.assert_array_equal(hist, hist_host)


def test_a_wrapped_inner_copies_nothing_it_need_not():
    x = torch.ones(4, dtype=torch.float64)
    v = torch.tensor(4.0, dtype=torch.float64)
    assert _inner.as_inner(lambda a, b: v, x.shape)(x, x) is v
    got = _inner.as_inner(lambda a, b: np.float64(2.0), x.shape)(x, x)
    assert isinstance(got, torch.Tensor) and float(got) == 2.0


@pytest.mark.parametrize("ran", [0, 1, 5, 8, 13, 35])
def test_recorded_steps_credit_the_launch_counts(ran):
    """A captured step's launches are recorded, not counted; the driver
    adds, for the steps the replays ran, what each recorded step launched:
    the counts read as if the host had launched every step."""
    from krylov_tpu_torch.ops import cuda_spmv, cuda_stencil

    steps = 4
    cuda_stencil.reset_launches()
    cuda_spmv.reset_launches()
    per_step = []
    for i in range(steps):  # step i launches K1 once, and K10 on odd steps
        with _graphs.recording() as launches:
            _graphs.count(cuda_stencil.LAUNCHES, "stencil2d_matvec")
            if i % 2:
                _graphs.count(cuda_spmv.LAUNCHES, "csr_matvec")
        per_step.append(launches)
    assert cuda_stencil.LAUNCHES["stencil2d_matvec"] == 0  # nothing ran
    loop = _driver._GraphLoop(None, 100, True, None)
    loop.per_step = per_step
    loop._ran(ran)
    assert cuda_stencil.LAUNCHES["stencil2d_matvec"] == ran
    assert cuda_spmv.LAUNCHES["csr_matvec"] == sum(i % steps % 2 for i in range(ran))
    assert cuda_stencil.LAUNCHES["cg_fused_phase_b"] == 0
    _graphs.count(cuda_stencil.LAUNCHES, "cg_fused_phase_b")  # outside a recording
    assert cuda_stencil.LAUNCHES["cg_fused_phase_b"] == 1
    cuda_stencil.reset_launches()
    cuda_spmv.reset_launches()


def test_assign_is_one_parallel_assignment():
    """The copy of a replay's last state into the static buffers: fields
    already in place cost nothing, a field whose source is another field's
    buffer is read before that buffer is written, and a cycle of buffers
    still assigns every field."""

    class S(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor
        c: torch.Tensor

    dst = S(torch.tensor([1.0]), torch.tensor([2.0]), torch.tensor([3.0]))
    _driver._assign(dst, S(dst.b, dst.a, dst.c))  # a swap, and c in place
    assert [float(t) for t in dst] == [2.0, 1.0, 3.0]
    _driver._assign(dst, S(dst.b, torch.tensor([7.0]), dst.a))  # a chain: c <- a <- b
    assert [float(t) for t in dst] == [1.0, 7.0, 2.0]
