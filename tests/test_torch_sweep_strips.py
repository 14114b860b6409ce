"""S1's strips and S2's packed streams, on the CPU.

S1, the grid sweep, runs a right-hand side on a thread-block cluster: CTA
``k`` owns a strip of the row in scan order, each strip scans its positions
to one affine map (lanes and warps, or segments), and the strips' maps are
folded in rank order.  ``cuda_triangular.strip_sweep_model`` computes a
sweep in that order in plain torch; here it is held to ``krylov_tpu``'s
``grid_lower_sweep`` / ``grid_upper_sweep`` on the same inputs (numpy,
seeded) for clusters of 1, 2, 3, 4 and 16 CTAs, rows narrower than, as wide
as and not a multiple of the cluster, the 5-point Laplacian and a random
9-point stencil whose ``dc != 0`` bands read across strips and wrap around
the row (``jnp.roll``), omega 1.3, complex128 and a batch of 3: float64 to
1e-12 and float32 to 1e-5 of the largest value.

S2, the level sweep, may read ``x`` of the levels up to W back in its run
from a window in shared memory, where the host's window place of each
entry (``LevelSchedule.slots``'s ``ent_win``) puts it.  Every window place
decodes to its entry's column; ILU(0) on a 5-point grid needs W = 1; and
``cuda_triangular.level_sweep_model`` (the slot arrays run level by level
with a simulated window ring) equals the plain version and matches the
reference's ``LevelScheduledTriangularSolve`` and ``StackedTriangularSweep``
with W forced to 0, 1 and 2 (the window's cap, W each run's reach under it)
and k = 1 and 3.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu_torch as kt
from krylov_tpu.ops import triangular as jtri
from krylov_tpu_torch.ops import cuda_triangular as ct
from krylov_tpu_torch.ops import stencil as tst
from krylov_tpu_torch.ops import triangular as ttri

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

M = 7  # grid rows: the sweep's chain; the strips are across a row
FIVE = ((-1, 0, 0, 0, 1), (0, -1, 0, 1, 0))
NINE = (tuple(r for r in (-1, 0, 1) for _ in range(3)), (-1, 0, 1) * 3)
NYS = (1, 2, 3, 4, 16, 37)  # below, at and not a multiple of 2, 3, 4 and 16 strips
STRIPS = (1, 2, 3, 4, 16)


def _coeffs(stencil, ny):
    """Coefficient planes (ndiag, M, ny), float64: the 5-point Laplacian
    (zero where a neighbour leaves the grid), or random 9-point planes with
    a dominant diagonal, their wrapped columns nonzero."""
    rng = np.random.default_rng(80 + ny)
    if stencil == "five":
        c = np.array([-1.0, -1.0, 4.0, -1.0, -1.0])[:, None, None] * np.ones((5, M, ny))
        c[0, 0], c[4, -1], c[1, :, 0], c[3, :, -1] = 0.0, 0.0, 0.0, 0.0
        return c, FIVE
    c = rng.standard_normal((9, M, ny))
    c[4] = 8.0 + rng.random((M, ny))
    return c, NINE


@functools.cache
def _reference(stencil, ny, upper, batch, dtype):
    """The reference's sweep (float64 or its dtype) and its inputs."""
    c, (ro, co) = _coeffs(stencil, ny)
    rng = np.random.default_rng(90 + ny)
    b = rng.standard_normal((batch, M, ny) if batch else (M, ny))
    if dtype == "complex128":
        b = b + 1j * rng.standard_normal(b.shape)
    if dtype == "float32":
        c, b = c.astype(np.float32), b.astype(np.float32)
    fn = jtri.grid_upper_sweep if upper else jtri.grid_lower_sweep
    bj = jnp.asarray(b)
    if batch:
        x = np.stack([np.asarray(fn(jnp.asarray(c), ro, co, bj[q], omega=1.3))
                      for q in range(batch)])
    else:
        x = np.asarray(fn(jnp.asarray(c), ro, co, bj, omega=1.3))
    return c, (ro, co), b, x


def _model(stencil, ny, upper, strips, threads=None, batch=0, dtype="float64"):
    c, (ro, co), b, want = _reference(stencil, ny, upper, batch, dtype)
    plan = ct.grid_plan(torch.from_numpy(c), ro, co, 1.3, torch.from_numpy(c).dtype,
                        upper, cluster=strips, threads=threads)
    assert (plan.cluster, plan.threads) == ct.sweep_shape(ny, strips, threads)
    got = ct.strip_sweep_model(plan, torch.from_numpy(b)).numpy()
    return got, want


def _close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("ny", NYS)
@pytest.mark.parametrize("strips", STRIPS)
@pytest.mark.parametrize("stencil", ["five", "nine"])
def test_strip_model_matches_reference(stencil, strips, ny, upper):
    """float64, one right-hand side: every cluster size on rows below, at
    and past it (a 9-point stencil needs rows of 2 or more: |dc| < ny)."""
    if stencil == "nine" and ny < 2:
        with pytest.raises(NotImplementedError, match="dc"):
            _model(stencil, ny, upper, strips)
        return
    got, want = _model(stencil, ny, upper, strips)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("stencil,strips,ny,threads,path", [
    (stencil, *case) for stencil in ("five", "nine") for case in (
        (1, 37, 32, (0, 2)),     # segments of two consecutive positions
        (1, 100, 32, (0, 4)),
        (2, 400, 32, (0, 7)),
        (3, 1000, 64, (0, 6)),
        (16, 37, 32, (1, 1)),    # strips of 3 positions, the last one empty
    )] + [("five", 4, 1024, None, (1, 1))])  # four strips of 256 columns
def test_strip_model_segments(stencil, strips, ny, threads, path, upper):
    """The kernel's layouts of a strip over its threads (``strip_layout``):
    one position a thread, or segments of consecutive positions folded in
    order where the strip is wider than its threads."""
    w, per, seg = ct.strip_layout(ny, *ct.sweep_shape(ny, strips, threads))
    assert (per, seg) == path
    got, want = _model(stencil, ny, upper, strips, threads)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("stencil", ["five", "nine"])
@pytest.mark.parametrize("what", ["float32", "complex128", "batch"])
def test_strip_model_types_and_batches(what, stencil, upper):
    """float32 to 1e-5 of the largest value, complex128 and a batch of 3
    right-hand sides (each the sweep of its own) to 1e-12, on 4 strips of a
    37-column row."""
    dtype = what if what != "batch" else "float64"
    got, want = _model(stencil, 37, upper, 4, batch=3 if what == "batch" else 0, dtype=dtype)
    _close(got, want, 1e-5 if what == "float32" else 1e-12)


def test_sweep_shape_picks_short_strips():
    """The plan's clusters: a CTA SWEEP_STRIP columns, at most
    SWEEP_CLUSTER_MAX of them; workers the strip's width in whole warps, up
    to SWEEP_THREADS_MAX."""
    assert ct.sweep_shape(4096) == (16, 256)
    assert ct.sweep_shape(1024) == (8, 128)
    assert ct.sweep_shape(45) == (1, 64)
    assert ct.sweep_shape(30000) == (16, 512)
    assert ct.strip_layout(30000, 16, 512) == (1875, 0, 4)
    assert ct.sweep_shape(1024, 1) == (1, 512)
    assert ct.strip_layout(1024, 1, 512) == (1024, 0, 2)
    A = tst.poisson_2d(8, 1024, dtype=np.float32, device="cpu")
    plan = ct.grid_plan(A.coeffs2d, A.row_offsets, A.col_offsets, 1.0, torch.float32, False)
    assert (plan.cluster, plan.threads) == (8, 128)


# ---------------------------------------------------------------------------
# S2: the packed streams and the window
# ---------------------------------------------------------------------------


def _grid_csr(g):
    n = g * g
    side = -np.ones(n - 1)
    side[g - 1::g] = 0.0
    return scipy.sparse.diags([-np.ones(n - g), side, 4.5 * np.ones(n), side, -np.ones(n - g)],
                              [-g, -1, 0, 1, g], format="csr")


def _unstructured(n=400, k=4, seed=81):
    """``k`` strictly lower neighbours a row drawn from all earlier rows,
    symmetrized: entries reach many levels back (past any window)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), k)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix((0.2 * rng.standard_normal(rows.shape[0]), (rows, cols)),
                                shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()
    return A


@functools.cache
def _factor(matrix, lower):
    """``(port sweep, its levels, reference sweep)`` of a factor: ILU(0) of
    a 32^2 grid (stacked levels), or a triangle of the unstructured matrix
    (level-scheduled, or stacked)."""
    if matrix == "ilu0 32^2":
        M = kt.ILUPreconditioner.from_scipy(_grid_csr(32))
        s = M._l if lower else M._u
        host = [t.numpy() for t in (s.rows, s.diag, s.dat, s.col, s.lrow)]
        ref = jtri.StackedTriangularSweep(*(jnp.asarray(a) for a in host), s.n_local)
        return s, ct.stacked_levels(*host, s.n_local), ref
    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(_unstructured()).tocsr()
    levels = ttri.level_arrays(tri, lower=lower, max_levels=4096)[1]
    if matrix == "unstructured":
        return (ttri.LevelScheduledTriangularSolve(tri, lower=lower, device="cpu"), levels,
                jtri.LevelScheduledTriangularSolve(tri, lower=lower))
    s = ttri.make_triangular_solve(tri, lower=lower, unroll_threshold=0, device="cpu")
    rows, diag, dat, col, lrow = jtri.stacked_level_arrays([tri], tri.shape[0], lower=lower)
    return s, levels, jtri.StackedTriangularSweep(
        *(jnp.asarray(a[0]) for a in (rows, diag, dat, col, lrow)), tri.shape[0])


MATRICES = ["ilu0 32^2", "unstructured", "unstructured stacked"]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("matrix", MATRICES)
def test_window_positions_decode_to_columns(matrix, lower):
    """In ``ent_win`` each entry of a run whose column lies 1 to
    LEVEL_WINDOW_MAX levels back in the run holds ``-1 - (back << 16 |
    i)``, row ``i`` of the level ``back`` before its own, which is its
    column; every other entry holds its column, as ``ent_col`` does."""
    sweep, levels, _ = _factor(matrix, lower)
    sched = sweep.schedule
    slots = sched.slots(levels)
    lp, ptr = slots["level_ptr"], slots["slot_ptr"]
    cols, win = slots["ent_col"], slots["ent_win"]
    np.testing.assert_array_equal(win[win >= 0], cols[win >= 0])
    near = 0
    for (kind, l0, l1), (W, R) in zip(
            [r for r in sched.launches if r[0] == "run"], slots["runs"]):
        assert R == max(sched.sizes[l0:l1]) and 0 <= W <= ct.LEVEL_WINDOW_MAX
        for l in range(l0, l1):
            e = np.arange(ptr[lp[l]], ptr[lp[l + 1]])
            level_of = {int(r): m for m in range(max(l0, l - ct.LEVEL_WINDOW_MAX), l)
                        for r in levels[m][0]}
            for q in e:
                if win[q] < 0:
                    p = -1 - win[q]
                    back, idx = p >> 16, p & 0xFFFF
                    assert 1 <= back <= W and levels[l - back][0][idx] == cols[q]
                    near += 1
                else:  # only what no window of the run reaches stays a column
                    assert int(cols[q]) not in level_of
    for kind, l0, l1 in sched.launches:
        if kind == "wide":
            e = np.arange(ptr[lp[l0]], ptr[lp[l1]])
            assert (win[e] >= 0).all()
    assert near > 0


@pytest.mark.parametrize("lower", [True, False])
def test_ilu0_on_a_5_point_grid_needs_a_window_of_one(lower):
    """Every entry of ILU(0) on a 5-point grid reads the level just before
    its own: W = 1; as k grows the window stays while two levels of rows x
    k values fit in LEVEL_SMEM, then goes.  A schedule made on the CPU has
    no runs of its own."""
    sweep, levels, _ = _factor("ilu0 32^2", lower)
    sched = sweep.schedule
    runs = sched.slots(levels)["runs"]
    (W, R), = runs
    assert W == 1 and R == 32
    assert sched.windows(1, 4, runs) == [1]
    k_max = ct.LEVEL_SMEM // (2 * R * 16)  # the most complex128 columns a window of one holds
    assert sched.windows(k_max, 16, runs) == [1] and sched.windows(k_max + 1, 16, runs) == [0]
    with pytest.raises(ValueError, match="made on the CPU"):
        sched.windows(1, 4)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("matrix", MATRICES)
def test_level_model_matches_plain_and_reference(matrix, lower, window, k, monkeypatch):
    """The slot arrays encoded with a window cap of ``window`` levels and
    run with each run's window as far back as its places reach (0 without
    a cap: every x from ``x``) equal the plain version to a few roundings
    (the same order of sums) and match the reference's sweep to 1e-12 of
    the largest value, float64."""
    monkeypatch.setattr(ct, "LEVEL_WINDOW_MAX", window)
    sweep, levels, _ = _factor(matrix, lower)
    sched = sweep.schedule
    slots = sched.slots(levels)
    windows = [reach for reach, _ in slots["runs"]]
    assert max(windows) == min(window, 1 if matrix.startswith("ilu0") else window)
    rng = np.random.default_rng(82 + k)
    b = rng.standard_normal((sched.n, k)) if k > 1 else rng.standard_normal(sched.n)
    got = ct.level_sweep_model(sched, slots, torch.from_numpy(b), windows).numpy()
    plain = sweep.plain(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-14 * float(np.abs(plain).max()))
    want = _reference_solve(matrix, lower, k)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * float(np.abs(want).max()))


@functools.cache
def _reference_solve(matrix, lower, k):
    """The reference's solve of the right-hand side that k's tests use
    (the reference compiles its unrolled level solve once a shape)."""
    sched = _factor(matrix, lower)[0].schedule
    rng = np.random.default_rng(82 + k)
    b = rng.standard_normal((sched.n, k)) if k > 1 else rng.standard_normal(sched.n)
    return np.asarray(_factor(matrix, lower)[2](jnp.asarray(b)))


def test_level_model_across_wide_levels(monkeypatch):
    """With a narrow bound of 40 rows the unstructured triangle alternates
    runs and wide levels: entries into an earlier run or a wide level stay
    device-memory reads, and the model still equals the plain version.  A
    window shorter than a run's places reach is refused."""
    monkeypatch.setattr(ct, "NARROW_ROWS", 40)
    sweep, levels, _ = _factor("unstructured", True)
    sched = ct.LevelSchedule(levels, sweep.n, None, torch.float64)
    kinds = [kind for kind, _, _ in sched.launches]
    assert "wide" in kinds and kinds.count("run") >= 2
    b = torch.from_numpy(np.random.default_rng(83).standard_normal((sched.n, 3)))
    slots = sched.slots(levels)
    windows = [reach for reach, _ in slots["runs"]]
    assert max(windows) >= 2
    got = ct.level_sweep_model(sched, slots, b, windows).numpy()
    want = sweep.plain(b).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="reach farther back"):
        ct.level_sweep_model(sched, slots, b, [max(w - 1, 1) if w > 1 else w for w in windows])
