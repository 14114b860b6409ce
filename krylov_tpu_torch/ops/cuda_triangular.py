"""Triangular-sweep kernels: the CUDA wrappers of S1 and S2, their launch
counters, S2's schedule and plain-torch models of the order each kernel
computes in (sources in ``krylov_tpu_torch/csrc/triangular.cu``).

* S1 :func:`grid_sweep` — ``(D/omega + L) x = b`` on a grid stencil's lower
  triangle, or ``(D/omega + U) x = b`` on its upper one
  (:class:`~krylov_tpu_torch.ops.triangular.GridLowerSweep`,
  :class:`~krylov_tpu_torch.ops.triangular.GridUpperSweep`), one launch a
  sweep of any batch: a thread-block cluster of ``plan.cluster`` CTAs a
  right-hand side, each CTA a strip of the row (:func:`strip_sweep_model`
  is its order on the host);
* S2 :func:`level_sweep` — ``x[rows_l] = (b[rows_l] - sum data * x[col]) /
  diag_l`` level after level
  (:class:`~krylov_tpu_torch.ops.triangular.StackedTriangularSweep`,
  :class:`~krylov_tpu_torch.ops.triangular.LevelScheduledTriangularSolve`),
  one launch for each run of narrow levels and one for each wide level
  (:class:`LevelSchedule`; :func:`level_sweep_model` runs its slot arrays
  and window on the host).

Neither replaces a TPU kernel: the reference runs these sweeps as XLA
loops (a ``lax.scan``), the port ran them as Python loops of launches, and
a CUDA graph of those loops would hold ~23.5k nodes a sweep at 1024^2.  S1
and S2 are numbered apart from K1-K12, which replace Pallas kernels.

A wrapper runs its plain version (the sweep classes' loops, passed in as
``plain``) only when its tensors lie on the CPU; on a CUDA device it
launches the kernel or raises: an unsupported dtype, a band set or a shape
the kernel does not take, a cluster the card does not schedule, and grad
mode with an input that requires a gradient (the kernels have no
backward).  Each launch adds one to ``LAUNCHES[name]``; a launch captured
into the CUDA graph of a ``while_loop`` solve counts once for each step
that a replay runs (:func:`krylov_tpu_torch._graphs.count`).  Nothing is read on
the host at a call: a schedule's launches are Python integers fixed at
set-up.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._graphs import count as _count
from .cuda_stencil import _CODES, _check, _on_cpu, _ptr, _refuse_grad, _require, _stream

LAUNCHES = {"grid_sweep": 0, "level_sweep": 0}

_TYPES = {torch.float32, torch.float64, torch.complex64, torch.complex128}

# The widest level a run takes (S2): a run is one CTA of 1024 threads
# (csrc/triangular.cu's KRYLOV_LEVEL_THREADS), which takes a level of up to
# 1024 rows in one pass of its threads and the next level after one block
# barrier, a fraction of a microsecond; a launch of its own costs a few.
# ILU(0) on a 2-D grid up to 1024^2 has levels of at most 1024 rows (a grid
# diagonal), so each of its factors is one run, one launch.
NARROW_ROWS = 1024

# S1: the columns a CTA of the cluster aims at, and the largest cluster (16
# is the card's non-portable size, taken where the occupancy API schedules
# it); a plan's cluster is ceil(ny / SWEEP_STRIP) CTAs up to that.
SWEEP_STRIP = 128
SWEEP_CLUSTER_MAX = 16
PORTABLE_CLUSTER = 8
SWEEP_THREADS_MAX = 512  # workers a CTA (and a publishing warp); a wider strip takes segments

# S2: the farthest level back an entry reads from the shared-memory window
# (W's cap), and the shared memory the window may take (csrc/
# triangular.cu's KRYLOV_LEVEL_SMEM).
LEVEL_WINDOW_MAX = 8
LEVEL_SMEM = 220 * 1024


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    from .. import _build

    return bind(_build.load())


def bind(lib):
    """``lib`` (a build of ``csrc/``, e.g. one with other tuning constants)
    with the sweeps' C signatures set."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
        ("krylov_error_string", [i32], ctypes.c_char_p),
        ("krylov_level_threads", [], i32),
        ("krylov_level_smem", [], i32),
        ("krylov_grid_sweep", [i32] + [vp] * 5 + [i32] * 6 + [vp] * 3 + [i32] * 2 + [vp] * 3,
         i32),
        ("krylov_level_sweep", [i32, vp, vp, vp, i32, vp, i32, vp], i32),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    if lib.krylov_level_threads() < NARROW_ROWS:
        raise RuntimeError("NARROW_ROWS exceeds csrc/triangular.cu's KRYLOV_LEVEL_THREADS")
    if lib.krylov_level_smem() < LEVEL_SMEM:
        raise RuntimeError("LEVEL_SMEM exceeds csrc/triangular.cu's KRYLOV_LEVEL_SMEM")
    return lib


def _dtype_check(name, dt):
    if dt not in _TYPES:
        raise TypeError(f"{name}: no CUDA kernel for {dt}; the sweeps take float32, "
                        "float64, complex64 and complex128")


# ---------------------------------------------------------------------------
# S1: the grid sweep
# ---------------------------------------------------------------------------


class GridPlan(NamedTuple):
    """What S1 reads besides ``b``, made once on the card
    (:func:`grid_plan`): the coefficient planes, ``a`` (the within-row
    factor ``-sub / d``, zero where ``d == 0`` and at the row's first
    position in scan order) and ``dsafe`` (``diag / omega``, 1 where it is
    0), all ``(., M, ny)`` in ``dtype``; the solved side's row bands as
    ``(plane, back, dc)``, ``back`` the rows back in sweep order; ``h`` the
    largest ``back``; the launch's shape: ``cluster`` CTAs of ``threads``
    threads a right-hand side."""

    coeffs: torch.Tensor
    a: torch.Tensor
    dsafe: torch.Tensor
    bands: tuple
    h: int
    upper: bool
    dtype: torch.dtype
    cluster: int = 1
    threads: int = 1024


def grid_bands(row_offsets, col_offsets, upper):
    """The bands a sweep reads, as the reference splits them:
    ``(diag, sub, row_bands)``, ``diag`` and ``sub`` band indices (``sub``
    the within-row band of the solved side, ``(0, -1)`` lower and ``(0, 1)``
    upper, or None), ``row_bands`` ``(d, back, dc)`` for the bands of the
    rows solved before (``dr < 0`` lower, ``dr > 0`` upper).  Bands of the
    other triangle are ignored; within-row coupling of a higher order
    raises ``NotImplementedError``, a stencil without a diagonal
    ``ValueError``."""
    sign = 1 if upper else -1
    diag = sub = None
    row_bands = []
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        if dr == 0 and dc == 0:
            diag = d
        elif dr == 0 and dc == sign:
            sub = d
        elif dr == 0 and dc * sign > 1:
            raise NotImplementedError(
                "grid_lower_sweep supports within-row coupling of order 1")
        elif dr * sign > 0:
            row_bands.append((d, dr * sign, dc))
    if diag is None:
        raise ValueError("stencil has no diagonal band")
    return diag, sub, row_bands


def sweep_shape(ny, cluster=None, threads=None):
    """S1's launch shape for rows of ``ny``: ``(cluster, threads)``, the
    CTAs a right-hand side (``ceil(ny / SWEEP_STRIP)`` up to
    ``SWEEP_CLUSTER_MAX`` unless given) and the worker threads a CTA (its
    strip's width in whole warps, up to :data:`SWEEP_THREADS_MAX`, unless
    given; each CTA has a publishing warp besides)."""
    C = int(cluster) if cluster else min(SWEEP_CLUSTER_MAX, max(1, -(-ny // SWEEP_STRIP)))
    w = -(-ny // C)
    nt = int(threads) if threads else min(SWEEP_THREADS_MAX, -(-w // 32) * 32)
    return C, nt


def strip_layout(ny, cluster, threads):
    """How S1's kernel lays a row over a cluster (csrc/triangular.cu's
    launch_grid_sweep): ``(w, per, seg)``, the positions a CTA, ``per`` 1
    for one position a thread (0: a segment of ``seg`` consecutive
    positions a thread)."""
    w = -(-ny // cluster)
    need = -(-w // threads)
    return (w, 1, 1) if need <= 1 else (w, 0, need)


def grid_plan(coeffs2d, row_offsets, col_offsets, omega, dtype, upper, cluster=None,
              threads=None):
    """S1's :class:`GridPlan` of a stencil's triangle, on ``coeffs2d``'s
    device: no doubling planes, no flipped copies.  The launch's shape is
    :func:`sweep_shape`'s; on the card a cluster of more than
    ``PORTABLE_CLUSTER`` CTAs that the occupancy API does not schedule is
    cut to that size when chosen here, and raises when given."""
    diag_d, sub_d, row_bands = grid_bands(row_offsets, col_offsets, upper)
    ny = coeffs2d.shape[-1]
    if len(row_bands) > 16 or any(abs(dc) >= ny for _, _, dc in row_bands):
        raise NotImplementedError(
            f"grid_sweep: row bands {row_bands} on rows of {ny}; the kernel takes at most 16, "
            "each with |dc| < ny")
    _dtype_check("grid_sweep", dtype)
    coeffs = coeffs2d.to(dtype).contiguous()
    diag = (coeffs2d[diag_d] / omega).to(dtype)
    dsafe = torch.where(diag != 0, diag, 1.0).to(dtype)
    a = torch.zeros_like(diag)
    if sub_d is not None:
        a = torch.where(diag != 0, -coeffs2d[sub_d].to(dtype) / dsafe, 0.0).to(dtype)
    a[:, -1 if upper else 0] = 0.0
    h = max((back for _, back, _ in row_bands), default=0)
    C, nt = sweep_shape(ny, cluster, threads)
    plan = GridPlan(coeffs, a.contiguous(), dsafe.contiguous(), tuple(row_bands), h,
                    bool(upper), dtype, C, nt)
    if coeffs.device.type == "cuda":
        active = grid_sweep_info(plan)["active"]
        if active < 1 and cluster is None and C > PORTABLE_CLUSTER:
            C, nt = sweep_shape(ny, PORTABLE_CLUSTER, threads)
            plan = plan._replace(cluster=C, threads=nt)
            active = grid_sweep_info(plan)["active"]
        _require(active >= 1, f"grid_sweep: the card schedules no cluster of {C} CTAs of {nt} "
                 f"threads for rows of {ny} in {dtype}")
    return plan


def _sweep_call(plan, dt, bb, x, nrhs, active, info):
    M, ny = plan.a.shape
    nb = len(plan.bands)
    arr = ctypes.c_int * max(nb, 1)
    lib = _lib()
    with torch.cuda.device(plan.a.device):
        err = lib.krylov_grid_sweep(
            _CODES[dt], _ptr(plan.coeffs), _ptr(plan.a), _ptr(plan.dsafe), _ptr(bb), _ptr(x),
            nrhs, M, ny, int(plan.upper), plan.h, nb,
            arr(*(p for p, _, _ in plan.bands)), arr(*(k for _, k, _ in plan.bands)),
            arr(*(c for _, _, c in plan.bands)), plan.cluster, plan.threads, active, info,
            _stream(plan.a))
    _check(lib, err, "grid_sweep")


def grid_sweep_info(plan, dtype=None):
    """What S1's launch of ``plan`` is on the card, asked of the occupancy
    API without launching: ``cluster``, ``threads``, ``per`` and ``seg``
    (:func:`strip_layout`), ``in_smem`` (the ring of solved strip rows in
    shared memory, else device memory), ``smem`` (its bytes), ``fetch``
    (how the next rows' inputs come: "cp.async", two rows ahead into
    shared memory, or "registers", one row ahead) and ``active`` (the
    clusters the card holds at once, 0 if it cannot hold one)."""
    dt = plan.dtype if dtype is None else dtype
    active = ctypes.c_int(0)
    info = (ctypes.c_int * 5)()
    _sweep_call(plan, dt, None, None, 1, ctypes.byref(active), info)
    return dict(cluster=plan.cluster, threads=plan.threads, per=info[0], seg=info[1],
                in_smem=bool(info[2]), smem=info[3],
                fetch=("registers", "cp.async")[info[4]], active=active.value)


def grid_sweep(plan, b2, plain):
    """S1: the sweep of ``plan`` (a :class:`GridPlan`, None for a sweep
    prepared on the CPU) applied to ``b2`` (``(M, ny)`` or a batch ``(...,
    M, ny)``), in the promoted type of the plan and ``b2``.  On the CPU
    ``plain(b2)``, the sweep's plain loop; on the card one launch, a cluster
    of ``plan.cluster`` CTAs a right-hand side."""
    if plan is None:  # prepared on the CPU
        _require(_on_cpu(b2), "grid_sweep: the sweep was prepared on the CPU; "
                 f"b is on {b2.device}")
        return plain(b2)
    _on_cpu(b2, plan.a)  # one CUDA device, or raises
    _refuse_grad("grid_sweep", b2, plan.coeffs)
    dt = torch.promote_types(plan.dtype, b2.dtype)
    _dtype_check("grid_sweep", dt)
    if dt != plan.dtype:  # a complex b on real planes: the planes cast for this call
        plan = plan._replace(coeffs=plan.coeffs.to(dt), a=plan.a.to(dt),
                             dsafe=plan.dsafe.to(dt), dtype=dt)
    M, ny = plan.a.shape
    _require(b2.ndim >= 2 and tuple(b2.shape[-2:]) == (M, ny),
             f"grid_sweep: b {tuple(b2.shape)} is not (..., {M}, {ny})")
    lead = tuple(b2.shape[:-2])
    bb = b2.to(dt).contiguous()
    x = torch.empty(bb.shape, dtype=dt, device=bb.device)
    if x.numel() == 0:
        return x
    _sweep_call(plan, dt, bb, x, x.numel() // (M * ny), None, None)
    _count(LAUNCHES, "grid_sweep")
    return x.reshape(lead + (M, ny))


def _scan_lanes(A, C):
    """Inclusive scan of affine maps ``y -> A y + C`` over the last axis,
    lane 0 first, by doubling as ``warp_scan_maps`` does."""
    lane = torch.arange(A.shape[-1], device=A.device)
    o = 1
    while o < A.shape[-1]:
        pa = torch.roll(A, o, dims=-1)
        pc = torch.roll(C, o, dims=-1)
        on = lane >= o
        C, A = torch.where(on, A * pc + C, C), torch.where(on, A * pa, A)
        o *= 2
    return A, C


def _pad_to(t, n, value):
    if t.shape[-1] == n:
        return t
    return torch.cat([t, t.new_full(t.shape[:-1] + (n - t.shape[-1],), value)], -1)


def _block_prefix(A, C):
    """The publishing warp's scan of a CTA's (..., L) warp maps, L <= 32:
    their exclusive prefixes and the strip's map."""
    L = A.shape[-1]
    A, C = _scan_lanes(_pad_to(A, 32, 1.0), _pad_to(C, 32, 0.0))
    pa = torch.cat([torch.ones_like(A[..., :1]), A[..., :-1]], -1)[..., :L]
    pc = torch.cat([torch.zeros_like(C[..., :1]), C[..., :-1]], -1)[..., :L]
    return pa, pc, A[..., 31], C[..., 31]


def _strip_entry(ta, tc):
    """The x entering each strip (..., C): the strips' maps scanned across
    the 16 lanes of the publishing warp (csrc/triangular.cu's
    KRYLOV_SWEEP_MAX_CLUSTER), strip k taking lane k - 1's."""
    A, C = _scan_lanes(_pad_to(ta, 16, 1.0), _pad_to(tc, 16, 0.0))
    return torch.cat([torch.zeros_like(tc[..., :1]), C[..., :ta.shape[-1] - 1]], -1)


def _strip_row(a_row, c_row, cluster, threads):
    """One row of S1 in the kernel's order: ``a_row`` and ``c_row`` (...,
    ny) in scan order, the row's x in scan order."""
    ny = c_row.shape[-1]
    w, per, seg = strip_layout(ny, cluster, threads)
    nwarps = threads // 32
    lead = c_row.shape[:-1]
    A = _pad_to(a_row.expand(c_row.shape), cluster * w, 1.0).reshape(lead + (cluster, w))
    Cc = _pad_to(c_row, cluster * w, 0.0).reshape(lead + (cluster, w))
    if per:  # position t of a strip: lane t % 32 of warp t // 32
        shape = lead + (cluster, nwarps, 32)
        A = _pad_to(A, threads, 1.0).reshape(shape)
        Cc = _pad_to(Cc, threads, 0.0).reshape(shape)
        A, Cc = _scan_lanes(A, Cc)
        pa, pc, ta, tc = _block_prefix(A[..., 31], Cc[..., 31])
        xin = (pa * _strip_entry(ta, tc)[..., None] + pc)[..., None]
        x = (A * xin + Cc).reshape(lead + (cluster, threads))[..., :w]
        return x.reshape(lead + (cluster * w,))[..., :ny]
    # a segment of `seg` consecutive positions a thread, folded in order
    A = _pad_to(A, seg * threads, 1.0).reshape(lead + (cluster, threads, seg))
    Cc = _pad_to(Cc, seg * threads, 0.0).reshape(lead + (cluster, threads, seg))
    TA, TC = torch.ones_like(Cc[..., 0]), torch.zeros_like(Cc[..., 0])
    for q in range(seg):
        TA, TC = A[..., q] * TA, A[..., q] * TC + Cc[..., q]
    shape = lead + (cluster, nwarps, 32)
    TA, TC = _scan_lanes(TA.reshape(shape), TC.reshape(shape))
    pa, pc, ta, tc = _block_prefix(TA[..., 31], TC[..., 31])
    xw = (pa * _strip_entry(ta, tc)[..., None] + pc)[..., None]
    ea = torch.roll(TA, 1, dims=-1)
    ec = torch.roll(TC, 1, dims=-1)
    first = torch.arange(32, device=xw.device) == 0
    xv = torch.where(first, xw, ea * xw + ec).reshape(lead + (cluster, threads))
    out = []
    for q in range(seg):
        xv = A[..., q] * xv + Cc[..., q]
        out.append(xv)
    x = torch.stack(out, -1).reshape(lead + (cluster, threads * seg))[..., :w]
    return x.reshape(lead + (cluster * w,))[..., :ny]


def strip_sweep_model(plan, b2):
    """S1's sweep of ``plan`` (a :class:`GridPlan` on any device) applied to
    ``b2`` in plain torch, in the kernel's order: rows in sweep order, each
    row's c from the solved rows (the wrap of ``jnp.roll`` across strips),
    each strip's positions scanned to maps by lanes and warps (or
    segments), the strips' maps scanned across lanes; sums agree with the
    kernel's to rounding (the card fuses multiply-adds)."""
    dt = torch.promote_types(plan.dtype, b2.dtype)
    M, ny = plan.a.shape
    b2 = b2.to(dt)
    coeffs, a, dsafe = plan.coeffs.to(dt), plan.a.to(dt), plan.dsafe.to(dt)
    order = torch.arange(ny - 1, -1, -1) if plan.upper else torch.arange(ny)
    rows = [None] * M
    for s in range(M):
        i = M - 1 - s if plan.upper else s
        r = b2[..., i, :]
        for p, back, dc in plan.bands:
            if s >= back:
                prev = rows[i + back if plan.upper else i - back]
                r = r - coeffs[p, i] * torch.roll(prev, -dc, dims=-1)
        c = r / dsafe[i]
        x = _strip_row(a[i][order], c[..., order], plan.cluster, plan.threads)
        rows[i] = x[..., torch.argsort(order)]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# S2: the level-scheduled sweep
# ---------------------------------------------------------------------------


class LevelSchedule:
    """S2's schedule of a triangular factor, made once on the host.

    ``levels``: one ``(rows, diag, dat, col, lrow)`` tuple of numpy arrays a
    level (:func:`~krylov_tpu_torch.ops.triangular.level_arrays`'s form,
    real rows and entries only).  The rows become slots, level after level;
    each slot's entries keep their stored order.  ``launches``: ``("run",
    l0, l1)`` for consecutive levels of at most :data:`NARROW_ROWS` rows,
    one CTA, and ``("wide", l, l + 1)`` for a wider level, many CTAs;
    together they hold every level once, in order.  On a CUDA ``device``
    the slot arrays (:meth:`slots`) go there (``tensors``) and ``runs``
    keeps their runs' reaches and widths; on the CPU nothing is made
    (``runs`` None).
    """

    def __init__(self, levels, n, device, dtype):
        self.n = int(n)
        self.nlevels = len(levels)
        self.sizes = [len(lv[0]) for lv in levels]
        self.launches = []
        run = None
        for l, size in enumerate(self.sizes):
            if size > NARROW_ROWS:
                if run is not None:
                    self.launches.append(("run", run, l))
                    run = None
                self.launches.append(("wide", l, l + 1))
            elif run is None:
                run = l
        if run is not None:
            self.launches.append(("run", run, self.nlevels))
        self.dtype = dtype
        self.tensors = None
        self._tables = {}
        self.runs = None
        if device is not None and torch.device(device).type == "cuda":
            slots = self.slots(levels)
            slots.pop("table")
            self.runs = slots.pop("runs")
            self.level_ptr = slots["level_ptr"]
            self.tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, self.dtype if k in ("slot_diag", "ent_val") else torch.int32)
                for k, v in slots.items()}

    def slots(self, levels):
        """What S2 reads besides ``b``, as numpy arrays: ``level_ptr`` (each
        level's first slot), ``slot_row``, ``slot_ptr`` (each slot's first
        entry), ``slot_diag``, ``ent_col``, ``ent_val``, ``ent_win`` (the
        columns again, but ``-1 - (back << 16 | i)`` where the column is row
        ``i`` of the level ``back`` (up to :data:`LEVEL_WINDOW_MAX`) before
        the entry's own in the same run: its place in the run's window),
        ``table``, a launch a row: ``(0 run / 1 wide, l0, l1, first slot,
        end slot)``, and ``runs``, each run's ``(reach, R)``: the farthest
        level back an entry of the run reads in ``ent_win``'s window and the
        run's widest level."""
        level_ptr = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        run_of = np.full(self.nlevels, -1, np.int64)  # each level's run's first level
        for kind, l0, l1 in self.launches:
            if kind == "run":
                run_of[l0:l1] = l0
        level_of = np.zeros(self.n, np.int64)
        index_of = np.zeros(self.n, np.int64)
        for l, lv in enumerate(levels):
            level_of[lv[0]] = l
            index_of[lv[0]] = np.arange(len(lv[0]))
        rows, diag, counts, cols, vals, wins = [], [], [], [], [], []
        reach = np.zeros(self.nlevels, np.int64)  # the farthest back an entry of the level reads
        for l, (r_, d_, v_, c_, lr_) in enumerate(levels):
            order = np.argsort(lr_, kind="stable")  # stored order within each row
            col = np.asarray(c_)[order]
            rows.append(np.asarray(r_))
            diag.append(np.asarray(d_))
            counts.append(np.bincount(np.asarray(lr_, np.int64), minlength=len(r_))[:len(r_)])
            cols.append(col)
            vals.append(np.asarray(v_)[order])
            back = l - level_of[col]
            near = (run_of[l] >= 0) & (level_of[col] >= run_of[l]) & (back <= LEVEL_WINDOW_MAX)
            wins.append(np.where(near, -1 - ((back << 16) | index_of[col]), col))
            reach[l] = back[near].max() if near.any() else 0
        slot_row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        slot_ptr = np.concatenate([[0], np.cumsum(np.concatenate(counts) if counts else [])])
        if slot_ptr[-1] >= 2 ** 31 or self.n >= 2 ** 31:
            raise NotImplementedError("level_sweep: int32 indices take < 2^31 rows and entries")
        if not np.array_equal(np.sort(slot_row), np.arange(self.n)):
            # S2 writes every row of x once and leaves nothing to a fill
            raise ValueError("level_sweep: the levels must hold every row of the factor once")
        runs = [(int(reach[l0:l1].max()), max(self.sizes[l0:l1]) or 1)
                for kind, l0, l1 in self.launches if kind == "run"]
        table = np.array([(0 if kind == "run" else 1, l0, l1, level_ptr[l0], level_ptr[l1])
                          for kind, l0, l1 in self.launches], np.int64).reshape(-1, 5)
        return dict(
            level_ptr=level_ptr, slot_row=slot_row, slot_ptr=slot_ptr,
            slot_diag=np.concatenate(diag) if diag else np.zeros(0),
            ent_col=np.concatenate(cols) if cols else np.zeros(0, np.int64),
            ent_val=np.concatenate(vals) if vals else np.zeros(0),
            ent_win=np.concatenate(wins) if wins else np.zeros(0, np.int64), table=table,
            runs=runs)

    def windows(self, k, itemsize, runs=None):
        """Each run's window W for ``k`` right-hand sides of ``itemsize``
        bytes: its reach (``runs``, :meth:`slots`'s; ``self.runs`` unless
        given) where W + 1 levels of its widest level's rows x ``k`` values
        fit in :data:`LEVEL_SMEM`, else 0 (the plain columns)."""
        runs = self.runs if runs is None else runs
        if runs is None:
            raise ValueError("level_sweep: a schedule made on the CPU has no slots; pass "
                             "runs=slots(levels)['runs']")
        return [w if (w + 1) * R * k * itemsize <= LEVEL_SMEM else 0 for w, R in runs]

    def table(self, k, itemsize):
        """S2's launch table for ``k`` right-hand sides of ``itemsize``
        bytes (a ctypes array, made once for each)."""
        key = (k, itemsize)
        if key not in self._tables:
            windows = iter(self.windows(k, itemsize))
            runs = iter(self.runs)
            rows = []
            for kind, l0, l1 in self.launches:
                s0, s1 = int(self.level_ptr[l0]), int(self.level_ptr[l1])
                if kind == "run":
                    W, (reach, R) = next(windows), next(runs)
                    _require(W == 0 or W >= reach,  # the kernel reads every place from the window
                             f"level_sweep: a window of {W} levels on a run that reaches {reach}")
                    rows += [0, l0, l1, s0, s1, W, R]
                else:
                    rows += [1, l0, l1, s0, s1, 0, 1]
            self._tables[key] = (ctypes.c_int * max(len(rows), 1))(*rows)
        return self._tables[key]


def stacked_levels(rows, diag, dat, col, lrow, n_local):
    """The real rows and entries of each padded level of
    :class:`~krylov_tpu_torch.ops.triangular.StackedTriangularSweep`'s
    arrays (numpy), in :class:`LevelSchedule`'s form: padded rows (row
    ``n_local``) and entries (local row ``mr``) dropped, the entries' local
    rows renumbered among the real rows."""
    mr = rows.shape[1] if rows.ndim == 2 else 0
    levels = []
    for l in range(rows.shape[0]):
        keep = rows[l] < n_local
        pos = np.cumsum(keep) - 1
        ent = lrow[l] < mr
        ent[ent] = keep[lrow[l][ent]]
        levels.append((rows[l][keep], diag[l][keep], dat[l][ent], col[l][ent],
                       pos[lrow[l][ent]]))
    return levels


def level_sweep(sched, b, plain):
    """S2: the triangular solve of ``sched`` (a :class:`LevelSchedule`)
    applied to ``b`` (``(n,)`` or ``(n, k)``), in the promoted type of the
    factor and ``b``.  On the CPU ``plain(b)``, the sweep's plain loop; on
    the card one launch for each entry of ``sched.launches``."""
    if sched.tensors is None:  # prepared on the CPU
        _require(_on_cpu(b), f"level_sweep: the sweep was prepared on the CPU; b is on {b.device}")
        return plain(b)
    t = sched.tensors
    _on_cpu(b, t["slot_row"])  # one CUDA device, or raises
    _refuse_grad("level_sweep", b)
    dt = torch.promote_types(sched.dtype, b.dtype)
    _dtype_check("level_sweep", dt)
    _require(b.ndim in (1, 2) and b.shape[0] == sched.n,
             f"level_sweep: b {tuple(b.shape)} is not ({sched.n},) or ({sched.n}, k)")
    if dt != sched.dtype:  # values cast for this call
        t = dict(t, slot_diag=t["slot_diag"].to(dt), ent_val=t["ent_val"].to(dt))
    bb = b.to(dt).contiguous()
    k = 1 if bb.ndim == 1 else bb.shape[1]
    x = torch.empty(bb.shape, dtype=dt, device=bb.device)
    if k == 0 or not sched.launches:
        return x
    ptrs = (ctypes.c_void_p * 7)(*(t[name].data_ptr() for name in (
        "level_ptr", "slot_row", "slot_ptr", "slot_diag", "ent_col", "ent_win", "ent_val")))
    lib = _lib()
    with torch.cuda.device(bb.device):
        err = lib.krylov_level_sweep(
            _CODES[dt], ptrs, _ptr(bb), _ptr(x), k, sched.table(k, dt.itemsize),
            len(sched.launches), _stream(bb))
    _check(lib, err, "level_sweep")
    for _ in sched.launches:
        _count(LAUNCHES, "level_sweep")
    return x


def level_sweep_model(sched, slots, b, window):
    """S2's solve of ``sched`` applied to ``b`` (``(n,)`` or ``(n, k)``) in
    plain torch, in the kernel's order: level after level from the slot
    arrays (:meth:`LevelSchedule.slots`); with ``window[i]`` > 0 every entry
    of run ``i`` that has a window place (``ent_win``) reads its ``x`` from
    a simulated window ring, every other from ``x`` (an int: that window
    for every run).  A window must be 0 or reach as far back as the run's
    places do, as the kernel's.  Every row's entries are summed in their
    stored order."""
    dt = torch.promote_types(torch.from_numpy(np.zeros(0, slots["ent_val"].dtype)).dtype,
                             b.dtype)
    b2 = (b[:, None] if b.ndim == 1 else b).to(dt)
    k = b2.shape[1]
    x = torch.zeros_like(b2)
    lp, ptr = slots["level_ptr"], slots["slot_ptr"]
    cols = torch.from_numpy(slots["ent_col"]).long()
    win = torch.from_numpy(slots["ent_win"]).long()
    place = torch.where(win < 0, -1 - win, 0)
    vals = torch.from_numpy(slots["ent_val"]).to(dt)
    nruns = sum(kind == "run" for kind, _, _ in sched.launches)
    windows = iter(window if isinstance(window, (list, tuple)) else [window] * nruns)
    for kind, l0, l1 in sched.launches:
        W = next(windows) if kind == "run" else 0
        ents = torch.arange(int(ptr[lp[l0]]), int(ptr[lp[l1]]))
        if W and bool(((win[ents] < 0) & (place[ents] >> 16 > W)).any()):
            raise ValueError(f"level_sweep_model: a window of {W} levels on a run whose "
                             "places reach farther back")
        ring = torch.zeros((W + 1, max(sched.sizes[l0:l1]), k), dtype=dt)
        for l in range(l0, l1):
            s = np.arange(lp[l], lp[l + 1])
            start, count = ptr[s], ptr[s + 1] - ptr[s]
            rows = torch.from_numpy(slots["slot_row"][s]).long()
            acc = torch.zeros((len(s), k), dtype=dt)
            for q in range(int(count.max(initial=0))):
                on = torch.from_numpy(count > q)
                e = torch.from_numpy(start)[on] + q
                back = place[e] >> 16
                near = (win[e] < 0) & (W > 0)
                xe = torch.where(near[:, None], ring[(l - back) % (W + 1), place[e] & 0xFFFF],
                                 x[cols[e]])
                acc[on] = acc[on] + vals[e][:, None] * xe
            xr = (b2[rows] - acc) / torch.from_numpy(slots["slot_diag"][s]).to(dt)[:, None]
            x[rows] = xr
            if W:
                ring[l % (W + 1), :len(s)] = xr
    return x[:, 0] if b.ndim == 1 else x
