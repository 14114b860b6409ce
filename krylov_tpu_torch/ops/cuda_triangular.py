"""Triangular-sweep kernels: the CUDA wrappers of S1 and S2, their launch
counters and S2's schedule (sources in ``krylov_tpu_torch/csrc/triangular.cu``).

* S1 :func:`grid_sweep` — ``(D/omega + L) x = b`` on a grid stencil's lower
  triangle, or ``(D/omega + U) x = b`` on its upper one
  (:class:`~krylov_tpu_torch.ops.triangular.GridLowerSweep`,
  :class:`~krylov_tpu_torch.ops.triangular.GridUpperSweep`), one launch a
  sweep of any batch;
* S2 :func:`level_sweep` — ``x[rows_l] = (b[rows_l] - sum data * x[col]) /
  diag_l`` level after level
  (:class:`~krylov_tpu_torch.ops.triangular.StackedTriangularSweep`,
  :class:`~krylov_tpu_torch.ops.triangular.LevelScheduledTriangularSolve`),
  one launch for each run of narrow levels and one for each wide level
  (:class:`LevelSchedule`).

Neither replaces a TPU kernel: the reference runs these sweeps as XLA
loops (a ``lax.scan``), the port ran them as Python loops of launches, and
a CUDA graph of those loops would hold ~23.5k nodes a sweep at 1024^2.  S1
and S2 are numbered apart from K1-K12, which replace Pallas kernels.

A wrapper runs its plain version (the sweep classes' loops, passed in as
``plain``) only when its tensors lie on the CPU; on a CUDA device it
launches the kernel or raises: an unsupported dtype, a band set or a shape the kernel does not
take, and grad mode with an input that requires a gradient (the kernels
have no backward).  Each launch adds one to ``LAUNCHES[name]``; a launch
captured into the ``while_loop`` driver's CUDA graph counts once for each
step that a replay runs (:func:`krylov_tpu_torch._graphs.count`).  Nothing
is read on the host at a call: a schedule's launches are Python integers
fixed at set-up.
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
        ("krylov_grid_sweep", [i32] + [vp] * 5 + [i32] * 6 + [vp] * 4, i32),
        ("krylov_level_sweep", [i32] + [vp] * 8 + [i32, vp, i32, vp], i32),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    if lib.krylov_level_threads() < NARROW_ROWS:
        raise RuntimeError("NARROW_ROWS exceeds csrc/triangular.cu's KRYLOV_LEVEL_THREADS")
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
    largest ``back``."""

    coeffs: torch.Tensor
    a: torch.Tensor
    dsafe: torch.Tensor
    bands: tuple
    h: int
    upper: bool
    dtype: torch.dtype


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


def grid_plan(coeffs2d, row_offsets, col_offsets, omega, dtype, upper):
    """S1's :class:`GridPlan` of a stencil's triangle, on ``coeffs2d``'s
    device: no doubling planes, no flipped copies."""
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
    return GridPlan(coeffs, a.contiguous(), dsafe.contiguous(), tuple(row_bands), h,
                    bool(upper), dtype)


def grid_sweep(plan, b2, plain):
    """S1: the sweep of ``plan`` (a :class:`GridPlan`, None for a sweep
    prepared on the CPU) applied to ``b2`` (``(M, ny)`` or a batch ``(...,
    M, ny)``), in the promoted type of the plan and ``b2``.  On the CPU
    ``plain(b2)``, the sweep's plain loop; on the card one launch, a CTA a
    right-hand side."""
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
    nrhs = x.numel() // max(M * ny, 1)
    if x.numel() == 0:
        return x
    nb = len(plan.bands)
    arr = ctypes.c_int * max(nb, 1)
    lib = _lib()
    with torch.cuda.device(bb.device):
        err = lib.krylov_grid_sweep(
            _CODES[dt], _ptr(plan.coeffs), _ptr(plan.a), _ptr(plan.dsafe), _ptr(bb), _ptr(x),
            nrhs, M, ny, int(plan.upper), plan.h, nb,
            arr(*(p for p, _, _ in plan.bands)), arr(*(k for _, k, _ in plan.bands)),
            arr(*(c for _, _, c in plan.bands)), _stream(bb))
    _check(lib, err, "grid_sweep")
    _count(LAUNCHES, "grid_sweep")
    return x.reshape(lead + (M, ny))


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
    the slot arrays (:meth:`slots`) go there (``tensors``) and the launch
    table to ``table``; on the CPU nothing does.
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
        if device is not None and torch.device(device).type == "cuda":
            slots = self.slots(levels)
            table = slots.pop("table")
            self.table = (ctypes.c_int * max(table.size, 1))(*table.ravel().tolist())
            self.tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, self.dtype if k in ("slot_diag", "ent_val") else torch.int32)
                for k, v in slots.items()}

    def slots(self, levels):
        """What S2 reads besides ``b``, as numpy arrays: ``level_ptr`` (each
        level's first slot), ``slot_row``, ``slot_ptr`` (each slot's first
        entry), ``slot_diag``, ``ent_col``, ``ent_val``, and ``table``, a
        launch a row: ``(0 run / 1 wide, l0, l1, first slot, end slot)``."""
        level_ptr = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        rows, diag, counts, cols, vals = [], [], [], [], []
        for r_, d_, v_, c_, lr_ in levels:
            order = np.argsort(lr_, kind="stable")  # stored order within each row
            rows.append(np.asarray(r_))
            diag.append(np.asarray(d_))
            counts.append(np.bincount(np.asarray(lr_, np.int64), minlength=len(r_))[:len(r_)])
            cols.append(np.asarray(c_)[order])
            vals.append(np.asarray(v_)[order])
        slot_row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        slot_ptr = np.concatenate([[0], np.cumsum(np.concatenate(counts) if counts else [])])
        if slot_ptr[-1] >= 2 ** 31 or self.n >= 2 ** 31:
            raise NotImplementedError("level_sweep: int32 indices take < 2^31 rows and entries")
        if not np.array_equal(np.sort(slot_row), np.arange(self.n)):
            # S2 writes every row of x once and leaves nothing to a fill
            raise ValueError("level_sweep: the levels must hold every row of the factor once")
        table = np.array([(0 if kind == "run" else 1, l0, l1, level_ptr[l0], level_ptr[l1])
                          for kind, l0, l1 in self.launches], np.int64).reshape(-1, 5)
        return dict(
            level_ptr=level_ptr, slot_row=slot_row, slot_ptr=slot_ptr,
            slot_diag=np.concatenate(diag) if diag else np.zeros(0),
            ent_col=np.concatenate(cols) if cols else np.zeros(0, np.int64),
            ent_val=np.concatenate(vals) if vals else np.zeros(0), table=table)


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
    lib = _lib()
    with torch.cuda.device(bb.device):
        err = lib.krylov_level_sweep(
            _CODES[dt], _ptr(t["level_ptr"]), _ptr(t["slot_row"]), _ptr(t["slot_ptr"]),
            _ptr(t["slot_diag"]), _ptr(t["ent_col"]), _ptr(t["ent_val"]), _ptr(bb), _ptr(x),
            k, sched.table, len(sched.launches), _stream(bb))
    _check(lib, err, "level_sweep")
    for _ in sched.launches:
        _count(LAUNCHES, "level_sweep")
    return x
