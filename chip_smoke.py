#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of the repository, with nothing built beforehand:

    python3 chip_smoke.py

It needs one CUDA device (Hopper: the kernels are built for sm_90a) and
``nvcc``, and imports only torch, numpy, scipy and ``krylov_tpu_torch``.
Phases, in order; any failure raises, so the exit code is nonzero:

0. device line (``nvidia-smi`` name and power limit), versions, kernel build;
1. every stencil kernel against its plain PyTorch version on the card, at
   small odd shapes and at the main paths' 4096^2 shape: K1 stencil matvec,
   K2 const stencil matvec on both of its kernels (the tiled one: float32,
   row length a multiple of 4, 16-byte boundaries; the general one: every
   other type, odd row lengths, offset views), with a count of which each
   case took, K3 / K5 / K4 fused CG phases, K8 / K9 damped-Jacobi sweeps;
   1b: K1, K2, K8 and K9 also on complex vectors;
2. golden CG in float64 on ``diag([1e-3, 2..100])``;
3. the twin of ``__graft_entry__.entry()`` (compiled CG on ``poisson_2d(128)``)
   and a converging solve of the same operator;
4. the main path at 4096^2 (16.7M rows): 100 iterations of ``cg``
   (``while_loop``) and of ``cg_stencil(fused=True)`` on ``poisson_2d`` and
   on ``diffusion_2d`` with lognormal coefficients, with launch counts,
   trajectory agreement and bitwise repeatability; at 1024^2 the kernel
   trajectory against a float64 CPU run of the plain versions;
4b. the same on the constant-coefficient ``poisson_2d_const(4096)``
   (the reference bench's ``cg100`` configuration: K3 + K4 fused, K2 in
   generic ``cg``);
4c. multigrid-preconditioned CG: ``poisson_2d_const(4096)`` with a
   manufactured solution to 1e-6 (the reference bench's ``cg_mg``
   configuration, K8) and a Galerkin hierarchy on a smooth ``diffusion_2d``
   at 1024^2 (K9), each held at 256^2 to a float64 CPU run;
6. general sparsity, the reference bench's sparse section: (a) K10 CSR
   SpMV (f32 and bf16 values, the adjoint, the 1024^2 Poisson CSR forward
   and adjoint, an RCM-reordered scrambled Poisson, and small matrices with
   empty rows, a row longer than a run, one row, rectangles and ragged
   sizes, on and off 16-byte boundaries, each repeated bit for bit), K11
   CSR SpMM (k = 1 to 64, one column to two slabs, f32 and bf16 values, on
   the same small matrices, the Poisson and the irregular CSR, on and off
   16-byte boundaries, each repeated bit for bit) and K12 BSR SpMM on both of its kernels
   (square blocks of 32, 64, 128, rectangles, a block row that is no whole
   number of 16-byte pieces, k = 1, 3, 8, 16, 17, 1, 3 and 7 blocks a block
   row, four dtypes, each repeated bit for bit, with a count of which kernel
   each case took) against their plain versions;
   (b) BiCGSTAB + Jacobi, GMRES (mgs, householder, cgs) and Jacobi CG on
   the bench's 1M-row scipy CSR matrices through ``as_operator`` ->
   ``PETOperator`` (K10), against their ``CSROperator`` twins on the card,
   repeated bitwise, and at 256^2 against a float64 CPU run; (c) CG with
   an ``(N, 8)`` right-hand side on the Poisson CSR (K11) and on a
   block-structured SPD matrix routed to ``BSROperator`` (K12);
7. fused Jacobi-preconditioned CG and the rest of the solver family: (a)
   K6 and K7 against their plain versions (4096^2, a ragged grid, 9 and 25
   bands); (b) ``cg_stencil(M="jacobi", fused=True)`` at 4096^2 on a smooth
   and on the lognormal field against its unfused twin and generic
   preconditioned ``cg``, at 1024^2 against float64, and to 1e-6 beside the
   unpreconditioned solve; (c) ``qmr``, ``bicg``, ``cgs``, ``tfqmr``,
   ``minres``, ``cg_pipelined``, ``cg_block`` and ``refine`` on the 1M-row
   shifted Poisson CSR with 6b's checks (the adjoint products counted); (d)
   the device rule: with no device argument, inputs land on the card;
8. the stationary path: ``richardson`` and ``jacobi`` at 4096^2 (K1 every
   step) against a float64 host iteration; ``gauss_seidel``, ``sor`` and
   ``ssor`` on ``poisson_2d(1024)`` through the grid sweeps and
   ``gauss_seidel`` on a 1M-row unstructured matrix through the
   level-scheduled sweeps (K10 every step), against scipy's sequential
   triangular solves in float64; ``cg`` on ``poisson_2d_const`` with
   ``ChebyshevPreconditioner`` over ``estimate_spectrum``'s interval at
   4096^2 (K2 eight times an application) and with ``SSORSmoother`` at
   256^2, to 1e-6 beside plain ``cg``; what a grid sweep costs;
9. the sparse preconditioners: (a-c) the reference bench's ``cg_amg`` cell,
   ``cg`` + ``AMGPreconditioner`` on the unshifted 1M-row Poisson CSR with
   the solve's ``PETOperator`` as the fine level (set-up cold and warm, the
   native set-up route asserted, K10 and K11 on every level and prolongator
   against their plain versions, one V-cycle against the same hierarchy on
   plain CSR levels, Jacobi and Chebyshev smoothing, an ``(N, 8)``
   right-hand side through K11); (e) ``BlockJacobiPreconditioner`` (block 64)
   beside point Jacobi on that matrix, and line against point Jacobi on an
   anisotropic Poisson at 256^2; (d) ``ILUPreconditioner`` (ILU(0)) as ``Ml``
   of ``bicgstab`` and ``gmres`` and as ``M`` of ``cg`` at 256^2, and its
   set-up at 1024^2 with the native and the numpy level pass; every solve
   held to its float64 residual on the host;
10. differentiable solves and profiling: (a) ``diffable.solve`` (``cg``,
   Jacobi ``M``) on the lognormal ``diffusion_2d(4096)`` f32 with ``b = A
   x*`` to 1e-6, its forward and backward wall times and the parameter
   VJP's share, ``b``'s gradient held to its adjoint residual in float64
   on the host, the coefficient gradient's directional derivative to a
   central difference (5e-2, the reference's on-chip band), ``<grad, c> =
   -L``; the same at 1024^2 in float64 on the card (1e-5); (b) K1's
   gradient at 4096^2 against autograd through its plain version; (c)
   ``gmres`` through the bench's 1M-row convected CSR (``PETOperator``, K10
   forward and adjoint); (d) the default leaves of 6c's ``BSROperator``
   (K12 and its data gradient against the plain one); (e)
   ``profiling.roofline_report`` for K1 with the card's published
   bandwidth, and ``profiling.trace`` around a solve, which must name K1;
11. the distribution layer (``krylov_tpu_torch.parallel``): (a)
   ``sharded_solve`` on a world of one NCCL rank at 4096^2, 300 fixed
   ``cg`` steps on ``poisson_2d`` (K1) and ``poisson_2d_const`` (K2)
   against single-device ``cg``, with µs a step of both, their difference,
   and a loop of the operator's matvec and of an ``all_reduce`` of a
   scalar; (b) four gloo ranks sharing the card (NCCL takes one rank a
   GPU, so every transfer is staged through the host; a check of the
   sharded paths, not a timing), each solve against the same solve on one
   device: the grid operator (K1, ``M_diag``, the shard monitor), the const
   stencil (K2, alone and under ``ChebyshevPreconditioner`` through
   ``M_factory``), CSR in halo and gather mode, PET (``qmr``: K10 and its
   adjoint; an ``(N, 8)`` b: K11), 6c's block matrix (K12), restarted
   ``gmres`` and ``make_sharded_solver`` on three right-hand sides;
12. the distributed preconditioners: (a) on a world of one NCCL rank at
   full width, ``cg`` + ``multigrid_factory()`` on ``poisson_2d_const(4096)``
   (the bench's ``cg_mg`` cell: K2 smoothing, K8 in the gathered coarse
   V-cycle) against single-device MG-CG (iterations within 2) and on the
   smooth ``diffusion_2d(4096)`` (``ShardedGalerkinMultigrid``, K1; explicit
   residual below 1e-3), ``cg`` + ``partition_amg`` on the bench's 1M-row
   Poisson CSR (the ``cg_amg`` cell: K10 on the PET fine level, the
   prolongator slab, its explicit adjoint and the tail) against its
   ``as_global()`` twin and the single-device ``AMGPreconditioner``, bit for
   bit twice, and ``partition_block_jacobi`` under ``cg`` and
   ``partition_ilu0`` under ``bicgstab`` at 256^2 against their twins; each
   with wall ms, iterations, launches per application, collectives per
   step and host set-up seconds; (b) four gloo ranks on the card: the three
   couplings of ``multigrid_factory``, the Galerkin cycle, ``partition_amg``
   with two sharded levels and Chebyshev smoothing, ``partition_ilu0``
   under ``qmr`` (``with_rmatvec``) and ``partition_block_jacobi``, each
   held to its single-device twin, every rank launching its kernel;
13. the device-resident loop: eleven ``while_loop`` cells at full width
   (generic ``cg`` and the three fused CGs at 4096^2, MG-CG, ``bicgstab``,
   ``qmr``, ``cg`` + Jacobi to 1500 steps and ``cg`` + AMG on the bench's
   1M-row CSR, ``cg`` with an ``(N, 8)`` b through K11 and K12), each on
   the route its cost rule picks and on ``_driver._host_stepped()``, six
   of them also under a capture forced by ``_driver._capture_at``,
   alternating, 10 repeats; then nine cells of the methods whose step
   depends on its step number (``gmres`` x3 on the convected 1M-row CSR,
   ``tfqmr``, ``cg_pipelined``, ``cg_block`` (K11), ``symmlq``, ``gcr`` on
   the shifted one, ``chebyshev`` on ``poisson_2d_const(1024)`` (K2)), all
   three routes, 5 repeats: every route bit-equal to the host-stepped
   loop, with equal launch counts, inputs unchanged, memory back at its
   level, the rule's median no slower than the host-stepped median by
   more than the larger spread, the forced route taking a capture and
   reading the stop flag less than once a step; each cell's wall, device
   busy, idle share, host steps before the capture, capture and
   instantiation ms, flag reads a step, the rule's route minus the host
   loop pair by pair, and the kept pool's size after a forced capture;
5. timings with CUDA events, each printed beside the card's name and power
   limit: every kernel with its plain version, its bound and, where one
   PyTorch call computes the same function, that call (K10 on the irregular
   matrix, its adjoint and the Poisson CSR, K11 at k = 8 and 16 on both,
   with ``bench.py``'s amortizations, K2 at 5, 9 and 25 bands and K12 at two
   shapes, by device time inside a CUDA graph as well); per-iteration
   slopes
   of the stencil solvers; time to solution of cg100, of MG-CG and of the
   sparse solves with the device's idle share (``torch.profiler``); each
   V-cycle level's share.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BIG = 4096  # the main path's grid side: 16.7M rows
MID = 1024  # the size checked against a float64 CPU run
TRAJ_RTOL = 2e-3  # the reference's own f32 trajectory band


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def wide(t):
    """``t`` in float64 (complex128 for complex tensors)."""
    return t.to(torch.complex128) if t.is_complex() else t.double()


def max_err(got, want):
    return float((wide(got) - wide(want)).abs().max())


def check_close(name, got, want, atol, rtol=0.0):
    err = max_err(got, want)
    bound = atol + rtol * float(wide(want).abs().max())
    ok = bool(
        ((wide(got) - wide(want)).abs() <= atol + rtol * wide(want).abs()).all()
    )
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol {rtol:g}, "
        f"bound at max {bound:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def timed(ms, plain_ms, nbytes, flops, library_ms=None):
    """One kernel's timing record: its time, its plain version's, the least
    time the card could take for the same work (the larger of the bytes the
    function must move, each input read once and each output written once,
    over the memory rate, and its float32 operations over the peak rate),
    and the time of the one PyTorch call computing the same function, where
    there is one."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, launches=20, replays=10):
    """Device time of one ``fn()`` inside a replayed CUDA graph of
    ``launches``: no host in the loop, so a kernel shorter than the host's
    own time per call (K10 on a 5-point matrix, K2) is timed and not the
    Python around it."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, replays) / launches


# ---------------------------------------------------------------------------


def phase_kernels(dev, cs, st):
    """K1, K5 and K4 against their plain versions on the card."""
    rng = np.random.default_rng(SEED)
    errs = {}

    def rand(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    a_small = np.exp(rng.standard_normal((45, 70)))
    cases = [
        ("poisson_2d(37,45) h=1", st.poisson_2d(37, 45, device=dev)),
        ("diffusion_2d(45,70)", st.diffusion_2d(a_small, device=dev)),
        ("poisson_3d(6,7,50) h=ny=7", st.poisson_3d(6, 7, 50, device=dev)),
    ]
    log("phase 1: kernels against their plain versions")
    for label, A in cases:
        M, ny = A.grid
        h = A.halo
        c64 = A.coeffs2d
        ro, co = A.row_offsets, A.col_offsets
        x64 = rand((M, ny), torch.float64)
        top, bot = rand((h, ny), torch.float64), rand((h, ny), torch.float64)
        xb = rand((3, M, ny), torch.float64)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            c, x = c64.to(dtype), x64.to(dtype)
            for tag, args in (
                ("", (c, x)),
                (" halos", (c, x, top.to(dtype), bot.to(dtype))),
                (" batch3", (c, xb.to(dtype))),
            ):
                cargs = args[:2] + (ro, co) + args[2:]
                want = cs.stencil2d_matvec_plain(*cargs)
                got = cs.stencil2d_matvec(*cargs)
                check_close(f"K1 {label} {dtype}{tag}", got, want,
                            atol=tol * float(want.abs().max()))
        # bf16: both accumulate in f32, outputs differ by one bf16 rounding
        for cd, xd in ((torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
            c, x = c64.to(cd), x64.to(xd)
            want = cs.stencil2d_matvec_plain(c, x, ro, co)
            got = cs.stencil2d_matvec(c, x, ro, co)
            assert got.dtype == want.dtype == torch.promote_types(cd, xd)
            check_close(f"K1 {label} {cd}/{xd}", got, want,
                        atol=1e-5 * float(want.float().abs().max()),
                        rtol=1e-2 if got.dtype == torch.bfloat16 else 0.0)
        r, p = rand((M, ny)), rand((M, ny))
        om = torch.tensor(0.7, device=dev)
        c = c64.float()
        want = cs.cg_fused_phase_a_var_plain(om, r, p, c, ro, co)
        got = cs.cg_fused_phase_a_var(om, r, p, c, ro, co)
        check_fused("K5 " + label, got, want)
        y, ap, al = rand((M, ny)), rand((M, ny)), torch.tensor(0.3, device=dev)
        want = cs.cg_fused_phase_b_plain(al, y.clone(), r.clone(), p, ap)
        got = cs.cg_fused_phase_b(al, y.clone(), r.clone(), p, ap)
        check_fused("K4 " + label, got, want)

    # the main path's shape: 4096^2, five bands, lognormal coefficients
    a = np.exp(np.random.default_rng(SEED + 1).standard_normal((BIG, BIG)))
    A = st.diffusion_2d(a.astype(np.float32), device=dev)
    ro, co, c = A.row_offsets, A.col_offsets, A.coeffs2d
    x = rand((BIG, BIG))
    want = cs.stencil2d_matvec_plain(c, x, ro, co)
    errs["stencil2d_matvec"] = check_close(
        f"K1 diffusion_2d({BIG}) f32", cs.stencil2d_matvec(c, x, ro, co), want,
        atol=1e-5 * float(want.abs().max()))
    r, p = rand((BIG, BIG)), rand((BIG, BIG))
    om = torch.tensor(0.7, device=dev)
    errs["cg_fused_phase_a_var"] = check_fused(
        f"K5 diffusion_2d({BIG})",
        cs.cg_fused_phase_a_var(om, r, p, c, ro, co),
        cs.cg_fused_phase_a_var_plain(om, r, p, c, ro, co))
    y, ap, al = rand((BIG, BIG)), rand((BIG, BIG)), torch.tensor(0.3, device=dev)
    errs["cg_fused_phase_b"] = check_fused(
        f"K4 {BIG}^2",
        cs.cg_fused_phase_b(al, y.clone(), r.clone(), p, ap),
        cs.cg_fused_phase_b_plain(al, y.clone(), r.clone(), p, ap))
    return errs, A


def check_fused(name, got, want, sum_rtol=1e-4):
    """Vectors at 1e-5 of their max; the reduced scalar at ``sum_rtol``
    (1e-4: the f32 summation-order band over 16.7M terms)."""
    err = 0.0
    for k, (g, w) in enumerate(zip(got[:2], want[:2])):
        err = max(err, check_close(f"{name} out{k}", g, w,
                                   atol=1e-5 * float(w.abs().max())))
    check_close(f"{name} scalar", got[2], want[2], atol=0.0, rtol=sum_rtol)
    return err


def rel_close(name, got, want, tol):
    """``got`` against ``want`` at ``tol`` of ``max |want|`` (bf16 outputs
    also at rtol 1e-2, one bf16 rounding apart)."""
    rtol = 1e-2 if got.dtype == torch.bfloat16 else 0.0
    scale = float(wide(want).abs().max())
    return check_close(name, got, want, atol=tol * scale, rtol=rtol)


TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-5,
       torch.complex64: 1e-5, torch.complex128: 1e-12}


def offset_copy(t):
    """``t``'s values one element off their allocation's start: for float32
    and int32 a contiguous view that lies on no 16-byte boundary (the case
    of K2's general kernel and of K10's 4-byte loads)."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


def square_stencil(st, rng, shape, h):
    """A const operator with every offset in [-h, h]^2 (9 bands for h = 1,
    25 for h = 2, a Galerkin coarse level's shape) and seeded weights."""
    offs = [(a, b) for a in range(-h, h + 1) for b in range(-h, h + 1)]
    return st.ConstStencilOperator(shape, offs, list(rng.standard_normal(len(offs))))


def random_bands(rng, M, ny, dtype, dev):
    """A seeded 25-band plane stack with every offset in [-2, 2]^2 (the
    shape of a Galerkin coarse level) and a weight plane."""
    pairs = [(a, b) for a in range(-2, 3) for b in range(-2, 3)]
    c = torch.from_numpy(rng.standard_normal((len(pairs), M, ny))).to(dev, dtype)
    w = torch.from_numpy(0.1 + rng.random((M, ny))).to(dev, dtype)
    return c, tuple(p[0] for p in pairs), tuple(p[1] for p in pairs), w


def phase_kernels_const(dev, cs, st, A_div):
    """Complex K1, K2, K3, K8 and K9 against their plain versions: small
    odd shapes, then the main paths' 4096^2 shapes."""
    rng = np.random.default_rng(SEED + 10)

    def rand(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    log("phase 1b: complex K1, K2, K8, K9; K2, K3, K8, K9 against their plain versions")
    A = st.poisson_2d(37, 45, device=dev)
    ro, co = A.row_offsets, A.col_offsets
    for cd, xd in ((torch.complex64, torch.complex64), (torch.float32, torch.complex64),
                   (torch.complex128, torch.complex128)):
        c = A.coeffs2d
        if cd.is_complex:
            c = c + 1j * rand(c.shape, torch.float64)
        c = c.to(cd)
        x = (rand(A.grid, torch.float64) + 1j * rand(A.grid, torch.float64)).to(xd)
        for tag, xx in (("", x), (" batch3", torch.stack([x, 2 * x, -x]))):
            rel_close(f"K1 poisson_2d(37,45) {cd}/{xd}{tag}",
                      cs.stencil2d_matvec(c, xx, ro, co),
                      cs.stencil2d_matvec_plain(c, xx, ro, co), TOL[xd])

    nonherm = st.ConstStencilOperator(
        (37, 45), [(0, 0), (1, 0), (0, -1), (1, 2), (-2, 1)],
        [4.0, -1.5, -0.5, 0.25, -0.75])

    # K2 has two kernels: float32 grids whose row length is a multiple of 4
    # take the tiled one when x, out and the halos lie on 16-byte boundaries
    # (cs.k2_tiled); everything else the general one.  The first three grids
    # have row lengths that are no multiple of 4 (general for every type),
    # the rest are tiled in float32: a ragged grid, row constraints (3-D), 9
    # and 25 bands.
    const_ops = [("poisson_2d_const(37,45)", st.poisson_2d_const(37, 45)),
                 ("poisson_3d_const(6,7,50)", st.poisson_3d_const(6, 7, 50)),
                 ("non-hermitian (37,45)", nonherm),
                 ("poisson_2d_const(1000,1500)", st.poisson_2d_const(1000, 1500)),
                 ("poisson_3d_const(6,7,48)", st.poisson_3d_const(6, 7, 48)),
                 ("9 bands (67,132)", square_stencil(st, rng, (67, 132), 1)),
                 ("25 bands (67,132)", square_stencil(st, rng, (67, 132), 2))]
    paths = {"tiled": 0, "general": 0}
    for label, Ac in const_ops:
        M, ny = Ac.grid
        h = cs.halo_rows([b[0] for b in Ac.bands])
        x64, xb64 = rand((M, ny), torch.float64), rand((3, M, ny), torch.float64)
        top, bot = rand((h, ny), torch.float64), rand((h, ny), torch.float64)
        # complex vectors: the same real parts and a seeded imaginary part
        cx = {id(t): t + 1j * rand(t.shape, torch.float64) for t in (x64, xb64, top, bot)}

        def as_(t, dtype):
            return (cx[id(t)] if dtype.is_complex else t).to(dtype)

        for dtype in (torch.float64, torch.float32, torch.bfloat16, torch.complex64,
                      torch.complex128):
            x = as_(x64, dtype)
            off = offset_copy(x)
            for tag, args, kw in (
                ("", (x, Ac.kernel_bands), {}),
                (" batch3", (as_(xb64, dtype), Ac.kernel_bands), {}),
                (" row0+halos", (x, Ac.bands),
                 dict(row0=5, top_halo=as_(top, dtype), bot_halo=as_(bot, dtype))),
                (" offset view", (off, Ac.kernel_bands), {}),
            ):
                cs.reset_launches()
                got = cs.const_stencil2d_matvec(*args, **kw)
                took = "tiled" if cs.K2_PATHS["tiled"] else "general"
                assert cs.K2_PATHS[took] == 1 and sum(cs.K2_PATHS.values()) == 1
                want = ("tiled" if dtype == torch.float32 and ny % 4 == 0
                        and tag != " offset view" else "general")
                assert took == want, f"K2 {label} {dtype}{tag} took the {took} kernel"
                paths[took] += 1
                assert got.dtype == dtype
                rel_close(f"K2 {label} {dtype}{tag} [{took}]", got,
                          cs.const_stencil2d_matvec_plain(*args, **kw), TOL[dtype])
                if took == "tiled" and not kw:  # the two kernels agree bit for bit
                    assert torch.equal(got, cs.const_stencil2d_matvec(
                        offset_copy(args[0]), Ac.kernel_bands))
        r64 = rand((M, ny), torch.float64)
        cx[id(r64)] = r64 + 1j * rand((M, ny), torch.float64)
        for dtype in (torch.float64, torch.float32, torch.complex64, torch.complex128):
            z, r = as_(x64, dtype), as_(r64, dtype)
            for update in (True, False):
                rel_close(f"K8 {label} {dtype} update={update}",
                          cs.jacobi_sweep_const(0.2, z, r, Ac.kernel_bands, update),
                          cs.jacobi_sweep_const_plain(0.2, z, r, Ac.kernel_bands, update),
                          TOL[dtype])
        r, p = rand((M, ny)), rand((M, ny))
        om = torch.tensor(0.7, device=dev)
        check_fused(f"K3 {label}", cs.cg_fused_phase_a(om, r, p, Ac.kernel_bands),
                    cs.cg_fused_phase_a_plain(om, r, p, Ac.kernel_bands))

    a_small = np.exp(rng.standard_normal((45, 70)))
    Ad = st.diffusion_2d(a_small, device=dev)
    var_cases = [("diffusion_2d(45,70) 5 bands", Ad.coeffs2d, Ad.row_offsets,
                  Ad.col_offsets, 0.8 / Ad.diagonal().reshape(Ad.grid)),
                 ("random 25 bands (37,45)",) + random_bands(rng, 37, 45, torch.float64, dev)]
    for label, c64, ro, co, w64 in var_cases:
        # (plane dtype, vector dtype): real, and complex vectors with real or
        # complex planes (K1's pairs)
        for cd, xd in ((torch.float64, torch.float64), (torch.float32, torch.float32),
                       (torch.complex64, torch.complex64), (torch.float32, torch.complex64),
                       (torch.complex128, torch.complex128),
                       (torch.float64, torch.complex128)):
            c, w = c64.to(cd), w64.to(cd)
            if cd.is_complex:
                c = c + 1j * rand(c.shape, torch.float64).to(cd)
                w = w + 0.1j * rand(w.shape, torch.float64).to(cd)
            z, r = rand(c.shape[1:], torch.float64), rand(c.shape[1:], torch.float64)
            if xd.is_complex:
                z = z + 1j * rand(z.shape, torch.float64)
                r = r + 1j * rand(r.shape, torch.float64)
            z, r = z.to(xd), r.to(xd)
            for update in (True, False):
                rel_close(f"K9 {label} {cd}/{xd} update={update}",
                          cs.jacobi_sweep_var(w, z, r, c, ro, co, update),
                          cs.jacobi_sweep_var_plain(w, z, r, c, ro, co, update),
                          TOL[xd])

    # the main paths' shapes: poisson_2d_const(4096) and diffusion_2d(4096)
    log(f"  K2 cases by kernel: {paths}")
    assert paths["tiled"] >= 12 and paths["general"] >= 100
    errs = {}
    Ac = st.poisson_2d_const(BIG)
    kb = Ac.kernel_bands
    x, r = rand((BIG, BIG)), rand((BIG, BIG))
    cs.reset_launches()
    errs["const_stencil2d_matvec"] = rel_close(
        f"K2 poisson_2d_const({BIG}) f32", cs.const_stencil2d_matvec(x, kb),
        cs.const_stencil2d_matvec_plain(x, kb), TOL[torch.float32])
    assert cs.K2_PATHS == {"tiled": 1, "general": 0}, "the main path's shape must be tiled"
    off = offset_copy(x)
    errs["const_stencil2d_matvec"] = max(errs["const_stencil2d_matvec"], rel_close(
        f"K2 poisson_2d_const({BIG}) f32, offset view [general]",
        cs.const_stencil2d_matvec(off, kb), cs.const_stencil2d_matvec_plain(x, kb),
        TOL[torch.float32]))
    assert cs.K2_PATHS == {"tiled": 1, "general": 1}
    del off
    om = torch.tensor(0.7, device=dev)
    errs["cg_fused_phase_a"] = check_fused(
        f"K3 poisson_2d_const({BIG})", cs.cg_fused_phase_a(om, r, x, kb),
        cs.cg_fused_phase_a_plain(om, r, x, kb))
    errs["jacobi_sweep_const"] = max(
        rel_close(f"K8 poisson_2d_const({BIG}) f32 update={u}",
                  cs.jacobi_sweep_const(0.2, x, r, kb, u),
                  cs.jacobi_sweep_const_plain(0.2, x, r, kb, u), TOL[torch.float32])
        for u in (True, False))
    c, ro, co = A_div.coeffs2d, A_div.row_offsets, A_div.col_offsets
    w = 0.8 / A_div.diagonal().reshape(A_div.grid)
    errs["jacobi_sweep_var"] = max(
        rel_close(f"K9 diffusion_2d({BIG}) f32 update={u}",
                  cs.jacobi_sweep_var(w, x, r, c, ro, co, u),
                  cs.jacobi_sweep_var_plain(w, x, r, c, ro, co, u), TOL[torch.float32])
        for u in (True, False))
    return errs


def phase_golden(dev, kt):
    log("phase 2: golden CG, float64 on the card")
    A = torch.diag(torch.tensor([1.0e-3] + list(range(2, 101)),
                                dtype=torch.float64, device=dev))
    b = torch.ones(100, dtype=torch.float64, device=dev)
    x, info = kt.cg(A, b)
    s = float(x.abs().sum())
    log(f"  success {info.success} numsteps {info.numsteps} sum|x| {s!r}")
    assert info.success and abs(s - 1004.1873775173957) <= 1e-11 * 1004.1873775173957


def inner(u, v):
    return torch.sum(u * v)


def phase_entry(dev, kt, st):
    log("phase 3: entry() twin, compiled CG on poisson_2d(128) f32")
    A = st.poisson_2d(128, dtype=np.float32, device=dev)
    b = torch.ones(A.grid, dtype=torch.float32, device=dev)
    _, info = kt.cg(A, b, inner=inner, tol=1e-5, maxiter=64, backend="while_loop")
    assert info.xk.shape == b.shape and bool(torch.isfinite(info.xk).all())
    assert info.resnorms.shape == (info.numsteps + 1,)
    assert np.isfinite(info.resnorms).all()
    log(f"  maxiter 64: numsteps {info.numsteps} resnorm ratio "
        f"{info.resnorms[-1] / info.resnorms[0]:.3e}")
    # converging solve: a manufactured solution keeps the f32 attainable
    # residual far below tol (b = 1 at 128^2 floors near 9e-4 in f32)
    xt = torch.from_numpy(
        np.random.default_rng(SEED + 2).standard_normal(A.grid).astype(np.float32)
    ).to(dev)
    b = A @ xt
    x, info = kt.cg(A, b, inner=inner, tol=1e-5, maxiter=2000, backend="while_loop")
    rel = float(torch.linalg.norm(b - A @ x) / torch.linalg.norm(b))
    log(f"  converging: success {info.success} numsteps {info.numsteps} "
        f"explicit |b-Ax|/|b| {rel:.3e}")
    assert info.success and rel <= 1e-5


def solve_pair(A, b, kt, cs, iters):
    """``iters`` steps of generic cg and of fused cg_stencil; returns both
    infos and the launch counts of each run."""
    counts = []
    infos = []
    for run in (
        lambda: kt.cg(A, b, inner=inner, tol=0.0, atol=0.0, maxiter=iters,
                      backend="while_loop"),
        lambda: kt.cg_stencil(A, b, tol=0.0, atol=0.0, maxiter=iters, fused=True),
    ):
        cs.reset_launches()
        _, info = run()
        torch.cuda.synchronize()
        counts.append(dict(cs.LAUNCHES, **{f"K2 {k}": n for k, n in cs.K2_PATHS.items()}))
        infos.append(info)
    return infos, counts


def agree(what, info, ref, steps):
    """Resnorm trajectories at TRAJ_RTOL over their first ``steps`` + 1
    entries; prints where the whole histories first leave the band."""
    rel = np.abs(info.resnorms - ref.resnorms) / ref.resnorms
    out = np.flatnonzero(rel > TRAJ_RTOL)
    first = "never" if out.size == 0 else f"at step {out[0]}"
    log(f"  {what}: max rel over steps 0..{steps} {rel[: steps + 1].max():.3e} "
        f"(rtol {TRAJ_RTOL}); over all {rel.max():.3e}, leaves the band {first}")
    assert info.numsteps == ref.numsteps and rel[: steps + 1].max() <= TRAJ_RTOL


def phase_main(dev, kt, cs, st, A_div):
    log(f"phase 4: main path at {BIG}^2 ({BIG * BIG} rows), 100 iterations")
    iters = 100
    totals = dict.fromkeys(cs.LAUNCHES, 0)
    # steps over which two f32 trajectories are held to TRAJ_RTOL.  On
    # i.i.d. lognormal coefficients f32 rounding grows about tenfold per
    # step once the extreme Ritz values converge: f32 against f64 leaves
    # the band at steps 9-11 at 512^2, in the reference package as here,
    # and f32 CG loses ~10% of the f64 energy decrease by step 50.  So that
    # cell is held over its first 5 steps (~1e-6 there), Poisson over all.
    stable = 5
    ops = [("poisson_2d", st.poisson_2d(BIG, dtype=np.float32, device=dev), iters),
           ("diffusion_2d", A_div, stable)]
    for label, A, steps in ops:
        b = torch.ones(A.grid, dtype=torch.float32, device=dev)
        (i_cg, i_fu), (n_cg, n_fu) = solve_pair(A, b, kt, cs, iters)
        for n in (n_cg, n_fu):
            for k in totals:
                totals[k] += n[k]
        log(f"  {label}: launches cg {n_cg} fused {n_fu}")
        assert i_cg.numsteps == i_fu.numsteps == iters
        assert n_cg["stencil2d_matvec"] >= iters
        assert n_fu["cg_fused_phase_a_var"] == iters
        assert n_fu["cg_fused_phase_b"] == iters
        for info in (i_cg, i_fu):
            assert bool(torch.isfinite(info.xk).all()) and np.isfinite(info.resnorms).all()
        log(f"  {label}: resnorm ratio after {iters} "
            f"{i_cg.resnorms[-1] / i_cg.resnorms[0]:.4e}")
        agree(f"{label} cg vs fused", i_fu, i_cg, steps)
        (j_cg, j_fu), _ = solve_pair(A, b, kt, cs, iters)
        same_fu = np.array_equal(j_fu.resnorms, i_fu.resnorms) and torch.equal(
            j_fu.xk, i_fu.xk)
        same_cg = np.array_equal(j_cg.resnorms, i_cg.resnorms) and torch.equal(
            j_cg.xk, i_cg.xk)
        log(f"  {label}: repeat bitwise equal: fused {same_fu}, cg {same_cg}")
        assert same_fu and same_cg

    log(f"  at {MID}^2: GPU f32 kernels against a CPU f64 run of the plain versions")
    a = np.exp(np.random.default_rng(SEED + 3).standard_normal((MID, MID)))
    for label, make, steps in (
        ("poisson_2d", lambda dt, d: st.poisson_2d(MID, dtype=dt, device=d), iters),
        ("diffusion_2d", lambda dt, d: st.diffusion_2d(
            a.astype(np.float32).astype(dt), device=d), stable),
    ):
        A_gpu, A_cpu = make(np.float32, dev), make(np.float64, "cpu")
        b = torch.ones(A_gpu.grid, dtype=torch.float32, device=dev)
        (g_cg, g_fu), _ = solve_pair(A_gpu, b, kt, cs, iters)
        _, ref = kt.cg_stencil(A_cpu, b.double().cpu(), tol=0.0, atol=0.0,
                               maxiter=iters)
        for name, info in (("cg", g_cg), ("fused", g_fu)):
            agree(f"{label} {name} f32 GPU vs f64 CPU", info, ref, steps)
    return totals


def phase_const_cg(dev, kt, cs, st):
    """The reference bench's cg100 configuration: 100 iterations of fused
    CG on poisson_2d_const(4096) (K3 + K4), against generic cg (K2)."""
    log(f"phase 4b: fused const CG on poisson_2d_const({BIG}), 100 iterations")
    iters = 100
    A = st.poisson_2d_const(BIG, device=dev)
    b = torch.ones(A.grid, dtype=torch.float32, device=dev)
    (i_cg, i_fu), (n_cg, n_fu) = solve_pair(A, b, kt, cs, iters)
    log(f"  launches cg {n_cg} fused {n_fu}")
    assert i_cg.numsteps == i_fu.numsteps == iters
    assert n_cg["const_stencil2d_matvec"] >= iters
    assert n_cg["K2 tiled"] == n_cg["const_stencil2d_matvec"], "K2's main path must be tiled"
    assert n_fu["cg_fused_phase_a"] == n_fu["cg_fused_phase_b"] == iters
    for info in (i_cg, i_fu):
        assert bool(torch.isfinite(info.xk).all()) and np.isfinite(info.resnorms).all()
    log(f"  resnorm ratio after {iters} {i_cg.resnorms[-1] / i_cg.resnorms[0]:.4e}")
    agree("poisson_2d_const cg vs fused", i_fu, i_cg, iters)
    (j_cg, j_fu), _ = solve_pair(A, b, kt, cs, iters)
    same_fu = np.array_equal(j_fu.resnorms, i_fu.resnorms) and torch.equal(j_fu.xk, i_fu.xk)
    same_cg = np.array_equal(j_cg.resnorms, i_cg.resnorms) and torch.equal(j_cg.xk, i_cg.xk)
    log(f"  repeat bitwise equal: fused {same_fu}, cg {same_cg}")
    assert same_fu and same_cg

    log(f"  at {MID}^2: GPU f32 kernels against a CPU f64 run of the plain versions")
    A_gpu, A_cpu = st.poisson_2d_const(MID, device=dev), st.poisson_2d_const(
        MID, dtype=np.float64, device="cpu")
    b = torch.ones(A_gpu.grid, dtype=torch.float32, device=dev)
    (g_cg, g_fu), _ = solve_pair(A_gpu, b, kt, cs, iters)
    _, ref = kt.cg_stencil(A_cpu, b.double().cpu(), tol=0.0, atol=0.0, maxiter=iters)
    for name, info in (("cg", g_cg), ("fused", g_fu)):
        agree(f"poisson_2d_const {name} f32 GPU vs f64 CPU", info, ref, iters)
    totals = dict.fromkeys(cs.LAUNCHES, 0)
    for n in (n_cg, n_fu):
        for k in totals:
            totals[k] += n[k]
    return totals


def smooth_field(n):
    """The reference tests' smooth coefficient field 1 + 0.9 sin cos."""
    X, Y = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    return 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)


def mg_cg(kt, A, b, M=None):
    """The reference bench's cg_mg solve: generic cg, one V(2,2) cycle as
    M, tol 1e-6, compiled driver."""
    M = kt.MultigridPreconditioner(A) if M is None else M
    return kt.cg(A, b, M=M, inner=inner, tol=1e-6, maxiter=30, backend="while_loop")


def manufactured(A, dev, seed):
    xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.grid)
                          .astype(np.float32)).to(dev)
    return xs, A @ xs


def agree_converged(what, info, ref):
    """Converged solves: equal numsteps, every recurrence entry at
    TRAJ_RTOL; the last entry (the explicit residual, at each precision's
    rounding floor) only has to pass the criterion, which success says."""
    rel = np.abs(info.resnorms - ref.resnorms[: len(info.resnorms)]) / ref.resnorms[
        : len(info.resnorms)]
    log(f"  {what}: numsteps {info.numsteps} vs {ref.numsteps}; max rel over the "
        f"recurrence {rel[:-1].max():.3e} (rtol {TRAJ_RTOL}); last entries "
        f"{info.resnorms[-1] / info.resnorms[0]:.3e} vs {ref.resnorms[-1] / ref.resnorms[0]:.3e}")
    assert info.success and ref.success and info.numsteps == ref.numsteps
    assert rel[:-1].max() <= TRAJ_RTOL


def phase_mg(dev, kt, cs, st):
    """MG-preconditioned CG: the cg_mg configuration at 4096^2 (K8 on every
    level's smoothing and residual) and a Galerkin hierarchy at 1024^2
    (K9), each held at 256^2 to a float64 CPU run of the plain versions."""
    log(f"phase 4c: multigrid-preconditioned CG, poisson_2d_const({BIG})")
    totals = dict.fromkeys(cs.LAUNCHES, 0)
    A = st.poisson_2d_const(BIG, device=dev)
    xs, b = manufactured(A, dev, SEED + 20)
    t0 = time.perf_counter()
    M = kt.MultigridPreconditioner(A)
    log(f"  hierarchy: {M.n_levels} levels {M._nd_shapes[0]} .. {M._nd_shapes[-1]}, "
        f"set-up {time.perf_counter() - t0:.2f} s")
    runs = []
    for _ in range(2):
        cs.reset_launches()
        _, info = mg_cg(kt, A, b, M)
        torch.cuda.synchronize()
        runs.append((info, dict(cs.LAUNCHES)))
    (info, n), (again, _) = runs
    fwd = float(torch.linalg.norm(info.xk - xs) / torch.linalg.norm(xs))
    sweeps = 4 * (M.n_levels - 1)  # per cycle: smooth - 1 + 1 + smooth sweeps a level
    log(f"  success {info.success} numsteps {info.numsteps} resnorm ratio "
        f"{info.resnorms[-1] / info.resnorms[0]:.3e} forward error |x - x*|/|x*| "
        f"{fwd:.3e}; launches {n}")
    assert info.success and info.numsteps <= 12
    assert n["jacobi_sweep_const"] >= (info.numsteps + 1) * sweeps
    assert n["jacobi_sweep_const"] % sweeps == 0 and n["jacobi_sweep_var"] == 0
    assert n["const_stencil2d_matvec"] >= info.numsteps
    same = np.array_equal(info.resnorms, again.resnorms) and torch.equal(info.xk, again.xk)
    log(f"  repeat bitwise equal: {same}")
    assert same
    for k in totals:
        totals[k] += n[k]

    log(f"  Galerkin hierarchy on diffusion_2d({MID}), a = 1 + 0.9 sin cos")
    Ag = st.diffusion_2d(smooth_field(MID).astype(np.float32), device=dev)
    xs, b = manufactured(Ag, dev, SEED + 21)
    t0 = time.perf_counter()
    Mg = kt.MultigridPreconditioner(Ag)
    log(f"  hierarchy: {Mg.n_levels} levels, bands per level "
        f"{[len(op.row_offsets) for op in Mg._ops]}, host set-up "
        f"{time.perf_counter() - t0:.2f} s")
    cs.reset_launches()
    _, ig = mg_cg(kt, Ag, b, Mg)
    torch.cuda.synchronize()
    n = dict(cs.LAUNCHES)
    fwd = float(torch.linalg.norm(ig.xk - xs) / torch.linalg.norm(xs))
    log(f"  success {ig.success} numsteps {ig.numsteps} resnorm ratio "
        f"{ig.resnorms[-1] / ig.resnorms[0]:.3e} forward error {fwd:.3e}; launches {n}")
    sweeps = 4 * (Mg.n_levels - 1)
    assert ig.success and n["jacobi_sweep_var"] >= (ig.numsteps + 1) * sweeps
    assert n["jacobi_sweep_var"] % sweeps == 0 and n["jacobi_sweep_const"] == 0
    assert n["stencil2d_matvec"] >= ig.numsteps
    for k in totals:
        totals[k] += n[k]

    small = 256
    log(f"  at {small}^2: GPU f32 kernels against a CPU f64 run of the plain versions")
    for label, make in (
        ("poisson_2d_const", lambda dt, d: st.poisson_2d_const(small, dtype=dt, device=d)),
        ("diffusion_2d Galerkin", lambda dt, d: st.diffusion_2d(
            smooth_field(small).astype(np.float32).astype(dt), device=d)),
    ):
        A_gpu, A_cpu = make(np.float32, dev), make(np.float64, "cpu")
        _, b = manufactured(A_gpu, dev, SEED + 22)
        _, g = mg_cg(kt, A_gpu, b)
        _, ref = mg_cg(kt, A_cpu, b.double().cpu())
        agree_converged(f"{label} MG-CG f32 GPU vs f64 CPU", g, ref)
    return totals


def phase_timing(dev, kt, cs, st, A_div, card):
    log(f"phase 5: timings on {card}")
    N = BIG * BIG
    A_p = st.poisson_2d(BIG, dtype=np.float32, device=dev)
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.standard_normal((BIG, BIG)).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((BIG, BIG)).astype(np.float32)).to(dev)
    y = torch.empty_like(x)
    pn, ap = torch.empty_like(x), torch.empty_like(x)
    om, al = torch.tensor(0.7, device=dev), torch.tensor(1e-3, device=dev)
    times = {}

    def gbs(ms, words):
        return words * N * 4 / (ms * 1e-3) / 1e9

    for label, A in (("poisson_2d", A_p), ("diffusion_2d", A_div)):
        c, ro, co = A.coeffs2d, A.row_offsets, A.col_offsets
        nd = c.shape[0]
        k1 = time_ms(lambda: cs.stencil2d_matvec(c, x, ro, co, out=y), 50)
        k1p = time_ms(lambda: cs.stencil2d_matvec_plain(c, x, ro, co), 10)
        k5 = time_ms(lambda: cs.cg_fused_phase_a_var(om, r, x, c, ro, co,
                                                     out=(pn, ap)), 50)
        k5p = time_ms(lambda: cs.cg_fused_phase_a_var_plain(om, r, x, c, ro, co), 10)
        log(f"  [{card}] {label} {BIG}^2 K1 stencil2d_matvec {k1 * 1e3:.1f} us "
            f"({gbs(k1, nd + 2):.0f} GB/s by the (ndiag+2)*N*4 byte model); "
            f"plain {k1p * 1e3:.1f} us")
        log(f"  [{card}] {label} {BIG}^2 K5 cg_fused_phase_a_var {k5 * 1e3:.1f} us "
            f"({gbs(k5, nd + 4):.0f} GB/s by (ndiag+4)*N*4); plain {k5p * 1e3:.1f} us")
        # K6: K5 with the dinv plane, on the same operator
        dinv = 1.0 / A.diagonal().reshape(A.grid)
        k6 = time_ms(lambda: cs.cg_fused_phase_a_var_jac(om, r, x, c, dinv, ro, co,
                                                         out=(pn, ap)), 50)
        k6p = time_ms(lambda: cs.cg_fused_phase_a_var_jac_plain(om, r, x, c, dinv, ro, co), 10)
        log(f"  [{card}] {label} {BIG}^2 K6 cg_fused_phase_a_var_jac {k6 * 1e3:.1f} us "
            f"({gbs(k6, nd + 5):.0f} GB/s by (ndiag+5)*N*4); plain {k6p * 1e3:.1f} us")
        times[label] = {
            "stencil2d_matvec": timed(k1, k1p, (nd + 2) * N * 4, 2 * nd * N),
            "cg_fused_phase_a_var": timed(k5, k5p, (nd + 4) * N * 4, (2 * nd + 4) * N),
            "cg_fused_phase_a_var_jac": timed(k6, k6p, (nd + 5) * N * 4, (2 * nd + 5) * N),
        }
    yv, rv = x.clone(), r.clone()
    k4 = time_ms(lambda: cs.cg_fused_phase_b(al, yv, rv, x, r), 50)
    k4p = time_ms(lambda: cs.cg_fused_phase_b_plain(al, yv, rv, x, r), 10)
    log(f"  [{card}] {BIG}^2 K4 cg_fused_phase_b {k4 * 1e3:.1f} us "
        f"({6 * N * 4 / (k4 * 1e-3) / 1e9:.0f} GB/s by 6*N*4); plain {k4p * 1e3:.1f} us")
    times["diffusion_2d"]["cg_fused_phase_b"] = timed(k4, k4p, 6 * N * 4, 6 * N)
    dinv = 1.0 / A_div.diagonal().reshape(A_div.grid)
    k7 = time_ms(lambda: cs.cg_fused_phase_b_jac(al, yv, rv, x, r, dinv), 50)
    k7p = time_ms(lambda: cs.cg_fused_phase_b_jac_plain(al, yv, rv, x, r, dinv), 10)
    log(f"  [{card}] {BIG}^2 K7 cg_fused_phase_b_jac {k7 * 1e3:.1f} us "
        f"({7 * N * 4 / (k7 * 1e-3) / 1e9:.0f} GB/s by 7*N*4); plain {k7p * 1e3:.1f} us")
    times["diffusion_2d"]["cg_fused_phase_b_jac"] = timed(k7, k7p, 7 * N * 4, 7 * N)

    # the const kernels on poisson_2d_const(4096), K9 on diffusion_2d's planes
    A_c = st.poisson_2d_const(BIG, device=dev)
    kb = A_c.kernel_bands
    c, ro, co = A_div.coeffs2d, A_div.row_offsets, A_div.col_offsets
    w = 0.8 / A_div.diagonal().reshape(A_div.grid)
    # the one PyTorch call that computes K2's function: a 3x3 convolution
    # with zero padding (timed only; cuDNN in full float32)
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    lap3 = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]],
                        device=dev).reshape(1, 1, 3, 3)
    x4 = x.reshape(1, 1, BIG, BIG)
    conv_err = max_err(F.conv2d(x4, lap3, padding=1)[0, 0], cs.const_stencil2d_matvec(x, kb))
    conv_ms = time_ms(lambda: F.conv2d(x4, lap3, padding=1), 20)
    log(f"  [{card}] {BIG}^2 library F.conv2d 3x3 padding=1 (K2's function): "
        f"{conv_ms * 1e3:.1f} us; max |conv - K2| {conv_err:.2e}")
    nb = len(kb)
    for name, kernel, plain, words, flops, model, lib in (
        ("const_stencil2d_matvec", lambda: cs.const_stencil2d_matvec(x, kb, out=y),
         lambda: cs.const_stencil2d_matvec_plain(x, kb), 2, 2 * nb, "2*N*4", conv_ms),
        ("cg_fused_phase_a", lambda: cs.cg_fused_phase_a(om, r, x, kb, out=(pn, ap)),
         lambda: cs.cg_fused_phase_a_plain(om, r, x, kb), 4, 2 * nb + 4, "4*N*4", None),
        ("jacobi_sweep_const", lambda: cs.jacobi_sweep_const(0.2, x, r, kb, out=y),
         lambda: cs.jacobi_sweep_const_plain(0.2, x, r, kb), 3, 2 * nb + 3,
         "3*N*4 (update)", None),
        ("jacobi_sweep_var", lambda: cs.jacobi_sweep_var(w, x, r, c, ro, co, out=y),
         lambda: cs.jacobi_sweep_var_plain(w, x, r, c, ro, co), c.shape[0] + 4,
         2 * c.shape[0] + 3, "(ndiag+4)*N*4 (update, 5 bands)", None),
    ):
        ms, plain_ms = time_ms(kernel, 50), time_ms(plain, 10)
        clock = ""
        if name == "const_stencil2d_matvec":
            # K2 is shorter than the host's own time per call when the host is
            # busy: the figure kept is the device time inside a CUDA graph
            clock = f" in a CUDA graph, {ms * 1e3:.1f} us in a Python loop"
            ms = graph_ms(kernel)
        log(f"  [{card}] {BIG}^2 {name} {ms * 1e3:.1f} us{clock} ({gbs(ms, words):.0f} GB/s by "
            f"{model}); plain {plain_ms * 1e3:.1f} us")
        times["const"] = dict(times.get("const", {}), **{
            name: timed(ms, plain_ms, words * N * 4, flops * N, lib)})
    # K2 with more bands (every offset in [-1, 1]^2 and [-2, 2]^2, seeded
    # weights), on the tiled kernel and, through an offset view, the general
    for h in (1, 2):
        kbh = square_stencil(st, rng, (BIG, BIG), h).kernel_bands
        xo = offset_copy(x)
        tiled = graph_ms(lambda: cs.const_stencil2d_matvec(x, kbh, out=y))
        general = graph_ms(lambda: cs.const_stencil2d_matvec(xo, kbh, out=y))
        log(f"  [{card}] {BIG}^2 const_stencil2d_matvec, {len(kbh)} bands: {tiled * 1e3:.1f} us "
            f"tiled, {general * 1e3:.1f} us general (offset view), in a CUDA graph; bound "
            f"{2 * N * 4 / HBM_BYTES_PER_S * 1e6:.1f} us by 2*N*4")
        del xo
    xo = offset_copy(x)
    general = graph_ms(lambda: cs.const_stencil2d_matvec(xo, kb, out=y))
    log(f"  [{card}] {BIG}^2 const_stencil2d_matvec, 5 bands, general kernel (offset view): "
        f"{general * 1e3:.1f} us in a CUDA graph")
    del xo

    # marginal per-iteration cost: slope of whole-solve time over maxiter
    for label, A in (("poisson_2d", A_p), ("diffusion_2d", A_div),
                     ("poisson_2d_const", A_c)):
        b = torch.ones(A.grid, dtype=torch.float32, device=dev)
        for name, solve in (
            ("cg", lambda n: kt.cg(A, b, inner=inner, tol=0.0, atol=0.0,
                                   maxiter=n, backend="while_loop")),
            ("cg_stencil fused", lambda n: kt.cg_stencil(
                A, b, tol=0.0, atol=0.0, maxiter=n, fused=True)),
        ) + (() if label != "diffusion_2d" else (
            ("cg_stencil Jacobi fused", lambda n: kt.cg_stencil(
                A, b, tol=0.0, atol=0.0, maxiter=n, fused=True, M="jacobi")),
            ("cg_stencil Jacobi unfused", lambda n: kt.cg_stencil(
                A, b, tol=0.0, atol=0.0, maxiter=n, fused=False, M="jacobi")),
        )):
            t = {}
            for n in (20, 120, 20, 120):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve(n)
                torch.cuda.synchronize()
                t[n] = min(t.get(n, 1e9), time.perf_counter() - t0)
            us = (t[120] - t[20]) / 100 * 1e6
            log(f"  [{card}] {label} {BIG}^2 {name}: {us:.1f} us/iteration "
                f"(slope over maxiter 20..120, best of 2)")

    # time to solution, best of 3: cg100 (fused const CG, 100 iterations)
    # and MG-CG to 1e-6 on a manufactured solution (set-up excluded)
    b = torch.ones(A_c.grid, dtype=torch.float32, device=dev)
    M = kt.MultigridPreconditioner(A_c)
    _, b_mg = manufactured(A_c, dev, SEED + 20)
    for name, solve in (
        ("cg100 cg_stencil fused", lambda: kt.cg_stencil(A_c, b, tol=0.0, atol=0.0,
                                                         maxiter=100, fused=True)),
        ("MG-CG V(2,2) to 1e-6", lambda: mg_cg(kt, A_c, b_mg, M)),
    ):
        solve()  # warm-up
        best = 1e9
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = solve()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        log(f"  [{card}] poisson_2d_const {BIG}^2 {name}: {best * 1e3:.2f} ms, "
            f"{info.numsteps} iterations, {best / info.numsteps * 1e6:.1f} us/iteration "
            f"(best of 3)")
        wall, busy, rows = profiled(solve, reps=3)
        log(f"  [{card}]   device busy {busy * 1e3:.2f} ms of {wall * 1e3:.2f} ms wall, idle "
            f"share {1 - busy / wall:.3f}; largest kernels (us per iteration): " + "; ".join(
                f"{key[:40]} x{count / info.numsteps:.1f} {us / info.numsteps:.1f}"
                for key, us, count in sorted(rows, key=lambda q: -q[1])[:6]))
    mg_levels(dev, M, card)
    return dict(times["diffusion_2d"], **times["const"])


def profiled(fn, reps=1):
    """(unprofiled wall s, best of ``reps`` synchronized calls; device-busy
    s per call; [(kernel, us, count)] per call) of ``fn``, by
    ``torch.profiler``'s CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall = 1e9
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps, e.count / reps)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall, sum(q[1] for q in rows) * 1e-6, rows


def mg_levels(dev, M, card):
    """Each level's own share of one V(2,2) cycle: the cycle started at the
    level less the cycle started one level down, in kernel launches and
    device-busy time.  The wall time is the whole cycle's: the cycle is
    host-bound at every depth, so differences of wall times are noise."""
    rng = np.random.default_rng(SEED + 23)
    costs = []
    for level, shape in enumerate(M._nd_shapes):
        r = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        wall, busy, rows = profiled(lambda r=r, level=level: M._vcycle(level, r), reps=20)
        costs.append((shape, wall, busy, sum(q[2] for q in rows)))
    _, wall, busy, launches = costs[0]
    log(f"  [{card}] V(2,2) cycle on poisson_2d_const({BIG}): wall {wall * 1e6:.1f} us "
        f"(best of 20), device busy {busy * 1e6:.1f} us, {launches:.0f} kernel launches "
        f"({wall / launches * 1e6:.1f} us of wall each); per level (launches, device us):")
    costs.append((None, 0.0, 0.0, 0))
    for (shape, _, busy, n), (_, _, busy_c, n_c) in zip(costs, costs[1:]):
        log(f"    level {str(shape):>14}: {n - n_c:5.0f} {(busy - busy_c) * 1e6:8.1f}")


# ---------------------------------------------------------------------------
# phase 6: general sparsity (scipy matrices through as_operator; K10-K12)

NPG = 1024  # the reference bench's Poisson side: 1,048,576 rows
SMALL_NPG = 256  # the size held to a float64 CPU run
NCSR = 1 << 20  # rows of the bench's irregular matrix
NBLK = 4096  # block rows of the block-structured SPD matrix


def irregular_csr():
    """The reference bench's irregular matrix (bench.py's csr_pet cell):
    2^20 rows, 5..49 entries a row, columns within +-512, f32, seed 7."""
    import scipy.sparse

    ncsr = NCSR
    crng = np.random.default_rng(7)
    row_nnz = crng.integers(5, 50, ncsr)
    cnnz = int(row_nnz.sum())
    indptr = np.zeros(ncsr + 1, np.int64)
    indptr[1:] = np.cumsum(row_nnz)
    rr = np.repeat(np.arange(ncsr), row_nnz)
    cc = np.clip(rr + crng.integers(-512, 512, cnnz), 0, ncsr - 1)
    return scipy.sparse.csr_matrix(
        (crng.standard_normal(cnnz).astype(np.float32), cc.astype(np.int32), indptr),
        shape=(ncsr, ncsr))


def poisson_csr(npg, diag=4.5):
    """The reference bench's Poisson CSR (f32), shifted by 0.5 unless
    ``diag=4.0``."""
    import scipy.sparse

    n = npg * npg
    return scipy.sparse.diags([-1.0, -1.0, diag, -1.0, -1.0], [-npg, -1, 0, 1, npg],
                              shape=(n, n), format="csr", dtype=np.float32)


def convected_csr(npg):
    """The bench's nonsymmetric variant for GMRES: + convection (-0.4, 0.4)."""
    import scipy.sparse

    n = npg * npg
    conv = scipy.sparse.diags([-0.4, 0.4], [-1, 1], shape=(n, n), format="csr",
                              dtype=np.float32)
    return (poisson_csr(npg) + conv).tocsr()


def block_spd_csr(R=32, seed=SEED + 40):
    """A block-tridiagonal SPD matrix of dense R x R blocks (f32):
    diagonal blocks Q Q^T / R + 3 I, couplings 0.1 N(0, 1) and their
    transposes; ``detect_blocksize`` routes it to BSROperator."""
    import scipy.sparse

    nb = NBLK
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nb, R, R))
    diag = q @ q.transpose(0, 2, 1) / R + 3.0 * np.eye(R)
    up = 0.1 * rng.standard_normal((nb - 1, R, R))
    rows = np.concatenate([np.arange(nb), np.arange(nb - 1), np.arange(1, nb)])
    cols = np.concatenate([np.arange(nb), np.arange(1, nb), np.arange(nb - 1)])
    blocks = np.concatenate([diag, up, up.transpose(0, 2, 1)])
    order = np.lexsort((cols, rows))
    indptr = np.searchsorted(rows[order], np.arange(nb + 1))
    return scipy.sparse.bsr_matrix((blocks[order].astype(np.float32), cols[order], indptr),
                                   shape=(nb * R, nb * R)).tocsr()


def scrambled_poisson(npg, seed=SEED + 41):
    import scipy.sparse

    perm = np.random.default_rng(seed).permutation(npg * npg)
    return poisson_csr(npg, 4.0)[perm][:, perm].tocsr()


def csr_tensors(sp, dev, value_dtype=torch.float32):
    return (torch.from_numpy(sp.indptr.astype(np.int32)).to(dev),
            torch.from_numpy(sp.indices.astype(np.int32)).to(dev),
            torch.from_numpy(sp.data).to(dev, value_dtype))


# K12's block shapes in 6a: the three sizes detect_blocksize knows, two
# rectangles, and a block row (30 values) that is no whole number of 16-byte
# pieces in the real types
K12_BLOCKS = ((32, 32), (64, 64), (128, 128), (48, 32), (16, 48), (32, 30))


def k10_edge_cases():
    """Small scipy CSR matrices (f32) on which K10's runs can go wrong:
    empty rows, a row longer than a run among short ones, one row, wide and
    tall rectangles, and row and entry counts that are multiples neither of
    a run nor of 4."""
    import scipy.sparse

    rng = np.random.default_rng(SEED + 45)
    n = 12001

    def band(n, lo, hi):
        counts = rng.integers(lo, hi, n)
        rows = np.repeat(np.arange(n), counts)
        cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
        return scipy.sparse.csr_matrix(
            (rng.standard_normal(rows.size).astype(np.float32), (rows, cols)), shape=(n, n))

    holes = band(n, 0, 4)  # a quarter of the rows empty, the first and the last forced
    holes = scipy.sparse.diags(np.r_[0.0, np.ones(n - 2), 0.0]).astype(np.float32) @ holes
    holes.eliminate_zeros()
    long_row = band(n, 5, 50).tolil()
    long_row[n // 2] = rng.standard_normal(n)  # 12001 entries: longer than any run
    long_row[3, ::2] = 1.0  # 6001 entries
    rect = scipy.sparse.random(3001, 777, density=0.02, random_state=5, format="csr",
                               dtype=np.float32)
    return [("empty rows", holes.tocsr()), ("a row of 12001 entries", long_row.tocsr()),
            ("n = 1", scipy.sparse.csr_matrix(rng.standard_normal((1, 7)).astype(np.float32))),
            ("rectangular 3001 x 777", rect), ("rectangular 777 x 3001", rect.T.tocsr()),
            ("ragged 12001 rows", band(n, 5, 50))]


K11_KS = (1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 64)  # one column to two slabs


def phase_sparse_kernels(dev, sv, bs):
    """6a: K10, K11 and K12 against their plain versions on the card.

    K10's and K11's tolerance is 1e-5 of the largest entry of the product
    everywhere: both sides multiply in float32 (K11 by fused multiply-adds)
    and sum each row in float32, in different orders (the kernels by lanes
    and a shuffle tree, the plain version by a segment sum), over at most 49
    terms on the bench matrices and 12001 on the long row; bf16 values widen
    to float32 exactly, so they get the same bound.  Every K10 and K11
    product is also repeated and must come out bit for bit."""
    log("phase 6a: K10, K11, K12 against their plain versions")
    errs = {"csr_matvec": 0.0, "csr_matmat": 0.0, "bsr_spmm": 0.0}
    rng = np.random.default_rng(SEED + 42)

    def vec(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def k11(label, arrays, m):
        """K11 at every k of K11_KS with f32 and bf16 values, on ``arrays``
        (a matrix of ``m`` columns) with the runs prepared, and on offset
        views of the columns, the values and X (the 4-byte paths) with the
        runs made on the spot."""
        runs = torch.from_numpy(sv.csr_runs(arrays[0].cpu().numpy())).to(dev)
        for vdt in (torch.float32, torch.bfloat16):
            a = arrays[:2] + (arrays[2].to(vdt),)
            off = (a[0], offset_copy(a[1]), offset_copy(a[2]))
            worst = 0.0
            for k in K11_KS:
                X = vec((m, k))
                want = sv.csr_matvec_plain(*a, X)
                bound = 1e-5 * float(want.abs().max())
                for tag, b, xx, r in (("", a, X, runs), (", offset views", off, offset_copy(X),
                                                         None)):
                    got = sv.csr_matmat(*b, xx, r)
                    torch.cuda.synchronize()
                    assert torch.equal(got, sv.csr_matmat(*b, xx, r)), \
                        f"K11 {label}, {vdt}, k={k}{tag} does not repeat bit for bit"
                    err = max_err(got, want)
                    if not err <= bound:
                        raise AssertionError(f"K11 {label}, {vdt}, k={k}{tag}: max_abs_err "
                                             f"{err:.3e} above {bound:.3e}")
                    worst = max(worst, err / bound if bound else 0.0)
                    errs["csr_matmat"] = max(errs["csr_matmat"], err)
                del X, want
            log(f"  K11 {label}, {vdt}, k = {', '.join(map(str, K11_KS))}, aligned and offset "
                f"views: worst error {worst:.2f} of the bound (1e-5 of the largest entry), "
                f"repeats bit for bit")

    def k10(label, arrays, x, got_fn):
        got = got_fn()
        torch.cuda.synchronize()
        assert torch.equal(got, got_fn()), f"K10 {label} does not repeat bit for bit"
        errs["csr_matvec"] = max(errs["csr_matvec"], rel_close(
            f"K10 {label}", got, sv.csr_matvec_plain(*arrays, x), 1e-5))

    for label, sp in k10_edge_cases():
        arrays = csr_tensors(sp, dev)
        x = vec(sp.shape[1])
        runs = torch.from_numpy(sv.csr_runs(sp.indptr)).to(dev)
        log(f"  {label}: {sp.shape[0]} x {sp.shape[1]}, {sp.nnz} entries, "
            f"{runs.numel() - 1} runs, longest row {np.diff(sp.indptr).max()}")
        for vdt in (torch.float32, torch.bfloat16):
            a = arrays[:2] + (arrays[2].to(vdt),)
            k10(f"{label}, {vdt}, runs prepared", a, x, lambda: sv.csr_matvec(*a, x, runs))
            # columns and values off the 16-byte boundary: the 4-byte loads
            b = (a[0], offset_copy(a[1]), offset_copy(a[2]))
            k10(f"{label}, {vdt}, offset views, runs made on the spot", b, x,
                lambda: sv.csr_matvec(*b, x))
        k11(label, arrays, sp.shape[1])
    lap = poisson_csr(NPG)
    op = sv.PETOperator.from_scipy(lap, with_rmatvec=True, device=dev)
    x = vec(lap.shape[1])
    k10(f"poisson {NPG}^2 forward (PETOperator)", csr_tensors(lap, dev), x, lambda: op @ x)
    k10(f"poisson {NPG}^2 adjoint (PETOperator.rmatvec)", csr_tensors(lap.T.tocsr(), dev), x,
        lambda: op.rmatvec(x))
    conv = convected_csr(NPG)  # nonsymmetric: the adjoint's CSR differs from the forward's
    op = sv.PETOperator.from_scipy(conv, with_rmatvec=True, device=dev)
    k10(f"convected poisson {NPG}^2 adjoint", csr_tensors(conv.T.tocsr(), dev), x,
        lambda: op.rmatvec(x))
    del op

    k11(f"poisson {NPG}^2", csr_tensors(lap, dev), lap.shape[1])
    sp = irregular_csr()
    log(f"  irregular matrix: {sp.shape[0]} rows, {sp.nnz} entries, "
        f"{sp.nnz / sp.shape[0]:.1f} a row, {len(sv.csr_runs(sp.indptr)) - 1} runs of at most "
        f"{sv.RUN_CAPACITY - 3} entries (K10 and K11)")
    ip, ix, data = csr_tensors(sp, dev)
    x = vec(sp.shape[1])
    for vdt in (torch.float32, torch.bfloat16):
        d = data.to(vdt)
        got = sv.csr_matvec(ip, ix, d, x)
        torch.cuda.synchronize()
        err = rel_close(f"K10 irregular values {vdt}", got, sv.csr_matvec_plain(ip, ix, d, x),
                        1e-5)
        errs["csr_matvec"] = max(errs["csr_matvec"], err)
    k11("irregular", (ip, ix, data), sp.shape[1])
    op = sv.PETOperator.from_scipy(sp, with_rmatvec=True, device=dev)
    spt = sp.T.tocsr()
    tp, tx, tdata = csr_tensors(spt, dev)
    got = op.rmatvec(x)
    torch.cuda.synchronize()
    errs["csr_matvec"] = max(errs["csr_matvec"], rel_close(
        "K10 irregular rmatvec (CSR of A^T)", got, sv.csr_matvec_plain(tp, tx, tdata, x), 1e-5))
    del op, tp, tx, tdata, spt
    scr = scrambled_poisson(NPG)
    op = sv.PETOperator.from_scipy(scr, reorder="rcm", device=dev)
    sip, six, sdata = csr_tensors(scr, dev)
    x = vec(scr.shape[1])
    got = op @ x
    torch.cuda.synchronize()
    errs["csr_matvec"] = max(errs["csr_matvec"], rel_close(
        f"K10 scrambled poisson({NPG}) reorder=rcm", got,
        sv.csr_matvec_plain(sip, six, sdata, x), 1e-5))

    # K12 on both kernels: the streamed one takes rows of whole 16-byte
    # pieces and k * itemsize <= 128 bytes, the general one the rest
    bs.reset_launches()
    for R, C in K12_BLOCKS:
        for max_blocks in (1, 3, 7):
            nbrows, nbcols = 64, 64
            cols = torch.from_numpy(rng.integers(0, nbcols, (nbrows, max_blocks))
                                    .astype(np.int32)).to(dev)
            for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
                blocks = torch.from_numpy(
                    rng.standard_normal((nbrows * max_blocks, R, C))).to(dev)
                if dtype.is_complex:
                    blocks = blocks + 1j * torch.from_numpy(
                        rng.standard_normal(blocks.shape)).to(dev)
                blocks = blocks.to(dtype)
                worst = 0.0
                for k in (1, 3, 8, 16, 17):
                    xb = torch.from_numpy(rng.standard_normal((nbcols * C, k))).to(dev)
                    xb = (xb + 1j * xb.flip(0) if dtype.is_complex else xb).to(dtype)
                    got = bs.bsr_spmm(blocks, cols, xb)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype
                    assert torch.equal(got, bs.bsr_spmm(blocks, cols, xb)), \
                        f"K12 {R}x{C} {dtype} k={k} does not repeat bit for bit"
                    want = bs.bsr_spmm_plain(blocks, cols, xb)
                    err = max_err(got, want)
                    bound = TOL[dtype] * float(wide(want).abs().max())
                    if not err <= bound:
                        raise AssertionError(
                            f"K12 {R}x{C} blocks={max_blocks} {dtype} k={k}: max_abs_err "
                            f"{err:.3e} above {bound:.3e}")
                    worst = max(worst, err / bound)
                    errs["bsr_spmm"] = max(errs["bsr_spmm"], err)
                log(f"  K12 {R}x{C} blocks, {max_blocks} a block row, {dtype}, k = 1, 3, 8, 16, "
                    f"17: worst error {worst:.2f} of the bound ({TOL[dtype]:g} of the largest "
                    f"entry), repeats bit for bit")
    log(f"  K12 launches by kernel: {bs.K12_PATHS}")
    assert min(bs.K12_PATHS.values()) > 0, "6a must reach both of K12's kernels"
    return errs


def agree_sparse(what, info, twin, failures, hold=None):
    """Two f32 solves of one system: numsteps within 1 and every common
    resnorm entry within TRAJ_RTOL (over the first ``hold`` steps when
    given); prints where the histories leave the band."""
    n = min(len(info.resnorms), len(twin.resnorms))
    rel = np.abs(info.resnorms[:n] - twin.resnorms[:n]) / twin.resnorms[:n]
    out = np.flatnonzero((rel > TRAJ_RTOL).reshape(n, -1).any(axis=1))
    first = "never" if out.size == 0 else f"at step {out[0]}"
    span = n if hold is None else min(n, hold + 1)
    ok = abs(info.numsteps - twin.numsteps) <= 1 and rel[:span].max() <= TRAJ_RTOL
    log(f"  {what}: numsteps {info.numsteps} vs {twin.numsteps}; max rel "
        f"{rel[:span].max():.3e} over steps 0..{span - 1} (rtol {TRAJ_RTOL}), leaves the "
        f"band {first} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(what)


def sparse_solves(kt, dev, npg, b_seed, dtype=np.float32):
    """The 6b solves of the reference bench on its matrices at side
    ``npg``, as {name: (matrix, solve)}: ``solve(A)`` runs the solve on
    ``A``, the scipy matrix (routed by as_operator) or an operator built
    from it."""
    lap, conv, lap0 = (m.astype(dtype) for m in (poisson_csr(npg), convected_csr(npg),
                                                  poisson_csr(npg, 4.0)))
    b = torch.from_numpy(np.random.default_rng(b_seed).standard_normal(npg * npg)
                         .astype(dtype)).to(dev)

    def jac(sp):
        return kt.DiagonalOperator(torch.from_numpy(1.0 / sp.diagonal()).to(dev))

    cases = {
        "bicgstab Ml=Jacobi": (lap, lambda A: kt.bicgstab(
            A, b, Ml=jac(lap), tol=1e-4, maxiter=400, backend="while_loop")),
        "cg M=Jacobi (unshifted, 1500 steps)": (lap0, lambda A: kt.cg(
            A, b, M=jac(lap0), tol=1e-4, maxiter=1500, backend="while_loop")),
    }
    for ortho in ("mgs", "householder", "cgs"):
        cases[f"gmres {ortho}"] = (conv, lambda A, o=ortho: kt.gmres(
            A, b, ortho=o, tol=1e-4, maxiter=120, backend="while_loop"))
    return cases, b


def run_sparse_cases(dev, kt, sv, make_cases, seeds, per_step, f64_hold=None,
                     twin_hold=None):
    """The checks 6b and 7c share, on the cases ``make_cases`` builds: each
    solve given the scipy matrix (routed by as_operator to PETOperator: K10,
    K11) against its CSROperator twin on the card over the whole history,
    (the first ``twin_hold[name]`` steps where given), repeated bitwise,
    with at least ``per_step(name)`` kernel launches a step; then at
    SMALL_NPG^2 against a float64 CPU run (over the first
    ``f64_hold[name]`` steps where given).  Returns the summed launch
    counts of the first runs and their infos."""
    from krylov_tpu_torch.ops.sparse import CSROperator

    failures, results = [], {}
    launches = dict.fromkeys(sv.LAUNCHES, 0)
    cases, _ = make_cases(kt, dev, NPG, seeds[0])
    for name, (sp, solve) in cases.items():
        op = kt.as_operator(sp, dev)
        assert type(op).__name__ == "PETOperator", type(op)
        runs = []
        for _ in range(2):
            sv.reset_launches()
            _, info = solve(sp)
            torch.cuda.synchronize()
            runs.append((info, dict(sv.LAUNCHES)))
        (info, n), (again, _) = runs
        for k in launches:
            launches[k] += n[k]
        key, least = per_step(name)
        log(f"  {name}: success {info.success} numsteps {info.numsteps} resnorm ratio "
            f"{np.max(info.resnorms[-1] / info.resnorms[0]):.3e}; launches {n}")
        assert bool(torch.isfinite(info.xk).all()) and np.isfinite(info.resnorms).all()
        assert n[key] >= least * info.numsteps, f"{key} did not carry every product"
        if not name.startswith("cg M=Jacobi"):  # the bench's cg_jacobi stops at 1500 unconverged
            assert info.success, f"{name} did not converge"
        same = np.array_equal(info.resnorms, again.resnorms) and torch.equal(info.xk, again.xk)
        log(f"  {name}: repeat bitwise equal: {same}")
        assert same
        twin = CSROperator.from_scipy(sp, device=dev)
        _, tinfo = solve(twin)
        agree_sparse(f"{name} PETOperator vs CSROperator", info, tinfo, failures,
                     hold=(twin_hold or {}).get(name))
        results[name] = info
        del twin

    log(f"  at {SMALL_NPG}^2: GPU f32 kernels against a CPU f64 run of the plain versions")
    small, _ = make_cases(kt, dev, SMALL_NPG, seeds[1])
    ref, _ = make_cases(kt, torch.device("cpu"), SMALL_NPG, seeds[1], np.float64)
    for name, (sp, solve) in small.items():
        if name.startswith("cg M=Jacobi"):
            continue  # 1500 unconverged steps: a float64 run parts from f32 by design
        assert type(kt.as_operator(sp, dev)).__name__ == "PETOperator"
        _, g = solve(sp)
        sp64, rsolve = ref[name]
        _, r = rsolve(sp64)  # float64 CSROperator on the CPU
        agree_sparse(f"{name} f32 GPU vs f64 CPU at {SMALL_NPG}^2", g, r, failures,
                     hold=(f64_hold or {}).get(name))
        assert g.success and r.success
    if failures:
        raise AssertionError(f"sparse trajectories disagree: {failures}")
    return launches, results


def phase_sparse_solves(dev, kt, sv):
    """6b: the reference bench's solves on its 1M-row CSR matrices through
    as_operator -> PETOperator (K10), against their CSROperator twins on
    the card, repeated bitwise, and at 256^2 against a float64 CPU run."""
    log(f"phase 6b: sparse solves on the {NPG}^2 Poisson CSR ({NPG * NPG} rows)")
    launches, results = run_sparse_cases(
        dev, kt, sv, sparse_solves, (SEED + 30, SEED + 31),
        lambda name: ("csr_matvec", {"bicgstab": 3, "cg": 1, "gmres": 1}[name.split()[0]]))
    return launches["csr_matvec"], results


def phase_sparse_blocked(dev, kt, sv, bs):
    """6c: cg with an (N, 8) right-hand side on the Poisson CSR (K11) and on
    a block-structured SPD matrix routed to BSROperator (K12).  The
    residual is scipy's float64 product on the host, so it does not rerun
    the kernel under test; after the counted solve each kernel is also
    held to its plain version on the solve's own operator and ``B``."""
    log("phase 6c: blocked right-hand sides, cg with b of shape (N, 8)")
    out, errs = {}, {}
    rng = np.random.default_rng(SEED + 43)
    for label, sp, kind, key in (
        (f"poisson CSR {NPG}^2", poisson_csr(NPG), "PETOperator", "csr_matmat"),
        (f"block-tridiagonal SPD, {NBLK} blocks of 32x32", block_spd_csr(), "BSROperator",
         "bsr_spmm"),
    ):
        op = kt.as_operator(sp, dev)
        assert type(op).__name__ == kind, type(op)
        B = torch.from_numpy(rng.standard_normal((sp.shape[0], 8)).astype(np.float32)).to(dev)
        sv.reset_launches()
        bs.reset_launches()
        x, info = kt.cg(sp, B, tol=1e-5, maxiter=300, backend="while_loop")
        torch.cuda.synchronize()
        n = {**sv.LAUNCHES, **bs.LAUNCHES}
        B64 = B.double().cpu().numpy()
        res = B64 - sp.astype(np.float64) @ x.double().cpu().numpy()
        rel = np.linalg.norm(res, axis=0) / np.linalg.norm(B64, axis=0)
        log(f"  {label}: routed to {type(op).__name__}; success {info.success} numsteps "
            f"{info.numsteps}; max explicit |b-Ax|/|b| (scipy, float64) {rel.max():.3e}; "
            f"launches {n}")
        assert info.success and tuple(x.shape) == tuple(B.shape) and rel.max() <= 2e-5
        assert n[key] >= info.numsteps
        out[key] = n[key]
        if kind == "PETOperator":
            arrays = (op._csr.indptr, op._csr.indices, op._csr.data)
            got, want = sv.csr_matmat(*arrays, B), sv.csr_matvec_plain(*arrays, B)
        else:
            got, want = bs.bsr_spmm(op.data, op.cols, B), bs.bsr_spmm_plain(op.data, op.cols, B)
        torch.cuda.synchronize()
        errs[key] = rel_close(f"{key} on the 6c operator and B, k=8", got, want, 1e-5)
    return out, errs


def sparse_timing(dev, kt, sv, bs, card):
    """Phase 5's general-sparsity part: K10, K11 and K12 with their plain
    versions (GB/s by the kernels' byte models), and the 6b solves' time to
    tolerance with the device's idle share."""
    from krylov_tpu_torch.ops.sparse import CSROperator

    times = {}
    rng = np.random.default_rng(SEED + 44)
    sp = irregular_csr()
    n, nnz = sp.shape[0], sp.nnz
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    lap = poisson_csr(NPG)
    m = lap.shape[0]
    xp = x[:m].clone()

    def library_ms(arrays, xv, runs):
        """The one PyTorch call computing K10's function (timed only), on
        the same arrays, by the same two clocks as K10."""
        lib_op = torch.sparse_csr_tensor(*arrays, size=(arrays[0].numel() - 1, xv.numel()))
        err = max_err(lib_op @ xv, sv.csr_matvec(*arrays, xv, runs))
        loop = time_ms(lambda: lib_op @ xv, 20)
        try:
            return graph_ms(lambda: lib_op @ xv), loop, err
        except RuntimeError:  # the library call does not capture into a graph here
            torch.cuda.synchronize()
            return loop, loop, err

    # K10 as PETOperator runs it: the runs cut once, outside the timed call.
    # Two clocks: a replayed CUDA graph (device time, the figure kept) and a
    # Python loop of launches (as earlier figures were taken; on the Poisson
    # matrix it measures the host).
    fwd, adj, pois = csr_tensors(sp, dev), csr_tensors(sp.T.tocsr(), dev), csr_tensors(lap, dev)
    k10_graph = {}
    for label, arrays, xv in (
        (f"irregular {n} rows {nnz} nnz, f32", fwd, x),
        ("irregular adjoint (CSR of A^T), f32", adj, x),
        ("irregular, bf16 values", fwd[:2] + (fwd[2].bfloat16(),), x),
        (f"poisson {NPG}^2 ({lap.nnz} nnz, 5 a row), f32", pois, xp),
    ):
        rows, entries, vb = arrays[0].numel() - 1, arrays[1].numel(), arrays[2].element_size()
        runs = torch.from_numpy(sv.csr_runs(arrays[0].cpu().numpy())).to(dev)
        ms = graph_ms(lambda: sv.csr_matvec(*arrays, xv, runs))
        loop = time_ms(lambda: sv.csr_matvec(*arrays, xv, runs), 50)
        plain = time_ms(lambda: sv.csr_matvec_plain(*arrays, xv), 10)
        by = entries * (4 + vb) + 8 * rows + 4 * rows
        record = timed(ms, plain, by, 2 * entries)
        log(f"  [{card}] K10 csr_matvec {label}, {runs.numel() - 1} runs: {ms * 1e3:.1f} us "
            f"in a CUDA graph ({by / (ms * 1e-3) / 1e9:.0f} GB/s by (4+{vb})*nnz + 8*n + 4*n; "
            f"bound {record['bound_ms'] * 1e3:.1f} us), {loop * 1e3:.1f} us in a Python loop; "
            f"plain {plain * 1e3:.1f} us")
        if vb == 4:
            lib, lib_loop, lib_err = library_ms(arrays, xv, runs)
            record["library_ms"] = lib
            log(f"  [{card}] library torch.sparse_csr_tensor @ x, the same arrays: "
                f"{lib * 1e3:.1f} us in a CUDA graph, {lib_loop * 1e3:.1f} us in a Python loop; "
                f"max |library - K10| {lib_err:.2e}")
        if arrays is fwd:
            times["csr_matvec"] = record
            k10_graph["irregular"] = ms
        if arrays is pois:
            k10_graph["poisson"] = ms
    del adj

    # K11 as PETOperator runs it at k = 8 and 16 on both matrices, by device
    # time in a CUDA graph, beside its plain version, the library call and
    # k launches of K10 on the same matrix (bench.py's amortization)
    for key, arrays in (("irregular", fwd), ("poisson", pois)):
        rows, entries = arrays[0].numel() - 1, arrays[1].numel()
        runs = torch.from_numpy(sv.csr_runs(arrays[0].cpu().numpy())).to(dev)
        lib_op = torch.sparse_csr_tensor(*arrays, size=(rows, rows))
        amort = {}
        for k in (8, 16):
            X = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(dev)
            ms = graph_ms(lambda: sv.csr_matmat(*arrays, X, runs))
            plain = time_ms(lambda: sv.csr_matvec_plain(*arrays, X), 10)
            lib_err = max_err(lib_op @ X, sv.csr_matmat(*arrays, X, runs))
            try:
                lib = graph_ms(lambda: lib_op @ X)
            except RuntimeError:  # the library call does not capture into a graph here
                torch.cuda.synchronize()
                lib = time_ms(lambda: lib_op @ X, 20)
            # one pass: the matrix streamed once, X read once, Y written once
            by = entries * 8 + 4 * rows + 2 * 4 * rows * k
            record = timed(ms, plain, by, 2 * entries * k, lib)
            amort[k] = k * k10_graph[key] / ms
            log(f"  [{card}] K11 csr_matmat {key} ({rows} rows, {entries} nnz) k={k}: "
                f"{ms * 1e3:.1f} us in a CUDA graph ({by / (ms * 1e-3) / 1e9:.0f} GB/s by 8*nnz + "
                f"4*n + 8*n*k; bound {record['bound_ms'] * 1e3:.1f} us, "
                f"{record['bound_ms'] / ms * 100:.0f} %); plain {plain * 1e3:.1f} us; library "
                f"torch.sparse_csr_tensor @ X {lib * 1e3:.1f} us, max |library - K11| "
                f"{lib_err:.2e}")
            if key == "poisson" and k == 8:
                times["csr_matmat"] = record
            del X
        log(f"  [{card}] {key}: csr_pet_spmm_amortization {amort[8]:.2f}, "
            f"csr_pet_spmm_k16_amortization {amort[16]:.2f} (k * t(K10) / t(K11), both in a "
            f"CUDA graph in this run)")
        del lib_op
    del fwd

    def k12_timed(label, data, cols, xb, by, flops, lib_op=None):
        """K12 by both clocks beside its plain version and, where given,
        the library call on the same blocks, all in this run."""
        ms = graph_ms(lambda: bs.bsr_spmm(data, cols, xb))
        loop = time_ms(lambda: bs.bsr_spmm(data, cols, xb), 50)
        plain = time_ms(lambda: bs.bsr_spmm_plain(data, cols, xb), 10)
        record = timed(ms, plain, by, flops)
        log(f"  [{card}] K12 bsr_spmm {label}: {ms * 1e3:.1f} us in a CUDA graph "
            f"({by / (ms * 1e-3) / 1e9:.0f} GB/s by the blocks' bytes + cols + x + y; bound "
            f"{record['bound_ms'] * 1e3:.1f} us), {loop * 1e3:.1f} us in a Python loop; plain "
            f"{plain * 1e3:.1f} us")
        if lib_op is not None:
            lib_err = max_err(lib_op @ xb, bs.bsr_spmm(data, cols, xb))
            lib_loop = time_ms(lambda: lib_op @ xb, 20)
            try:
                lib = graph_ms(lambda: lib_op @ xb)
            except RuntimeError:  # the library call does not capture into a graph here
                torch.cuda.synchronize()
                lib = lib_loop
            record["library_ms"] = lib
            log(f"  [{card}] library torch.sparse_bsr_tensor @ X, the same blocks: "
                f"{lib * 1e3:.1f} us in a CUDA graph, {lib_loop * 1e3:.1f} us in a Python loop; "
                f"max |library - K12| {lib_err:.2e}")
        return record

    bs.reset_launches()
    nbrows, max_blocks, R = 256, 3, 128
    cols = torch.from_numpy(rng.integers(0, nbrows, (nbrows, max_blocks)).astype(np.int32)).to(dev)
    blocks = torch.from_numpy(rng.standard_normal((nbrows * max_blocks, R, R))
                              .astype(np.float32)).to(dev)
    for k in (1, 8):
        xb = torch.from_numpy(rng.standard_normal((nbrows * R, k)).astype(np.float32)).to(dev)
        k12_timed(f"{nbrows} block rows x {max_blocks} blocks of {R}x{R} f32, k={k}", blocks,
                  cols, xb, blocks.numel() * 4 + cols.numel() * 4 + 2 * nbrows * R * k * 4,
                  2 * blocks.numel() * k)
    del blocks

    # K12 at phase 6c's own shape: the block-tridiagonal SPD matrix's
    # operator, NBLK block rows x 3 blocks of 32x32, k = 8, beside the one
    # PyTorch call computing K12's function: a BSR tensor of the same 32x32
    # blocks (without the kernel's ELL padding) times X
    bsp = block_spd_csr()
    bop = kt.as_operator(bsp, dev)
    xb = torch.from_numpy(rng.standard_normal((bop.shape[1], 8)).astype(np.float32)).to(dev)
    bsr = bsp.tobsr(blocksize=(32, 32))
    bsr.sort_indices()
    lib_op = torch.sparse_bsr_tensor(
        torch.from_numpy(bsr.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(bsr.indices.astype(np.int64)).to(dev),
        torch.from_numpy(bsr.data.astype(np.float32)).to(dev), size=bsr.shape)
    true_blocks = bsr.data.shape[0]
    times["bsr_spmm"] = k12_timed(
        f"6c's operator, {bop.cols.shape[0]} block rows x {bop.cols.shape[1]} blocks of 32x32 "
        f"f32 ({true_blocks} stored), k=8", bop.data, bop.cols, xb,
        true_blocks * 32 * 32 * 4 + bop.cols.numel() * 4 + 2 * bop.shape[0] * 8 * 4,
        2 * true_blocks * 32 * 32 * 8, lib_op)
    log(f"  K12 launches by kernel while timed: {bs.K12_PATHS}")
    assert bs.K12_PATHS["general"] == 0, "the timed shapes must take the streamed kernel"
    del bop, xb, lib_op

    # a solve given the scipy matrix pays as_operator's route-cache lookup
    # (a checksum of the whole of each buffer, two numpy passes) on every
    # call: timed apart, and the solves below take the routed operator
    kt.as_operator(lap, dev)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        kt.as_operator(lap, dev)
        best = min(best, time.perf_counter() - t0)
    log(f"  [{card}] as_operator cache hit on the poisson {NPG}^2 CSR ({lap.nnz} nnz): "
        f"{best * 1e3:.2f} ms (best of 3)")
    cases, _ = sparse_solves(kt, dev, NPG, SEED + 30)
    # the reference bench's qmr cell beside them
    cases["qmr Ml=Jacobi"] = family_solves(kt, dev, NPG, SEED + 52)[0]["qmr Ml=Jacobi"]
    for name, (sp, solve) in cases.items():
        for route, A in (("PETOperator", kt.as_operator(sp, dev)),
                         ("CSROperator", CSROperator.from_scipy(sp, device=dev))):
            solve(A)
            best = 1e9
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = solve(A)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            wall, busy, rows = profiled(lambda: solve(A))
            log(f"  [{card}] {name} on {route}: {best * 1e3:.2f} ms to "
                f"{'tolerance' if info.success else 'maxiter'}, {info.numsteps} iterations "
                f"(best of 2); device busy {busy * 1e3:.2f} of {wall * 1e3:.2f} ms, idle share "
                f"{1 - busy / wall:.3f}; largest: " + "; ".join(
                    f"{key[:32]} x{count:.0f} {us / 1e3:.2f} ms"
                    for key, us, count in sorted(rows, key=lambda q: -q[1])[:4]))
    return times


# ---------------------------------------------------------------------------
# phase 7: fused Jacobi CG (K6, K7), the rest of the solver family on the
# 1M-row matrices, and the device rule


def phase_jacobi_kernels(dev, cs, st, A_div):
    """7a: K6 and K7 against their plain versions on the card: 4096^2 with
    five bands, a ragged 1000 x 1500 grid, and 9- and 25-band offset sets;
    ``dinv`` positive and seeded.  Vectors at 1e-5 of their max, the two
    sums at rtol 1e-5."""
    log("phase 7a: K6, K7 against their plain versions")
    rng = np.random.default_rng(SEED + 50)

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    a_ragged = np.exp(rng.standard_normal((1000, 1500))).astype(np.float32)
    A_rag = st.diffusion_2d(a_ragged, device=dev)
    c25, ro25, co25, _ = random_bands(rng, 257, 515, torch.float32, dev)
    nine = [k for k in range(25) if abs(ro25[k]) <= 1 and abs(co25[k]) <= 1]
    cases = [
        (f"diffusion_2d({BIG}) 5 bands", A_div.coeffs2d, A_div.row_offsets, A_div.col_offsets),
        ("diffusion_2d(1000,1500) 5 bands", A_rag.coeffs2d, A_rag.row_offsets,
         A_rag.col_offsets),
        ("random 9 bands (257,515)", c25[nine].contiguous(),
         tuple(ro25[k] for k in nine), tuple(co25[k] for k in nine)),
        ("random 25 bands (257,515)", c25, ro25, co25),
    ]
    errs = {"cg_fused_phase_a_var_jac": 0.0, "cg_fused_phase_b_jac": 0.0}
    om, al = torch.tensor(0.7, device=dev), torch.tensor(0.3, device=dev)
    for label, c, ro, co in cases:
        shape = tuple(c.shape[1:])
        r, p, y, ap = rand(shape), rand(shape), rand(shape), rand(shape)
        dinv = torch.from_numpy((0.1 + rng.random(shape)).astype(np.float32)).to(dev)
        got = cs.cg_fused_phase_a_var_jac(om, r, p, c, dinv, ro, co)
        torch.cuda.synchronize()
        errs["cg_fused_phase_a_var_jac"] = max(errs["cg_fused_phase_a_var_jac"], check_fused(
            f"K6 {label}", got,
            cs.cg_fused_phase_a_var_jac_plain(om, r, p, c, dinv, ro, co), sum_rtol=1e-5))
        got = cs.cg_fused_phase_b_jac(al, y.clone(), r.clone(), p, ap, dinv)
        torch.cuda.synchronize()
        errs["cg_fused_phase_b_jac"] = max(errs["cg_fused_phase_b_jac"], check_fused(
            f"K7 {label}", got,
            cs.cg_fused_phase_b_jac_plain(al, y.clone(), r.clone(), p, ap, dinv),
            sum_rtol=1e-5))
    return errs


def jacobi_solves(A, b, kt, cs, iters, **stop):
    """Fused Jacobi cg_stencil, its unfused twin and generic cg with
    M = DiagonalOperator(1 / diag): infos, and the fused run's launches."""
    cs.reset_launches()
    _, fused = kt.cg_stencil(A, b, maxiter=iters, fused=True, M="jacobi", **stop)
    torch.cuda.synchronize()
    counts = dict(cs.LAUNCHES)
    _, unfused = kt.cg_stencil(A, b, maxiter=iters, fused=False, M="jacobi", **stop)
    dinv = 1.0 / A.diagonal().reshape(A.grid)
    _, generic = kt.cg(A, b, M=kt.DiagonalOperator(dinv), inner=inner, maxiter=iters,
                       backend="while_loop", **stop)
    return fused, unfused, generic, counts


def phase_jacobi_cg(dev, kt, cs, st, A_div):
    """7b: Jacobi-preconditioned fused CG (K6 + K7) at 4096^2 on a smooth
    and on the lognormal coefficient field, 100 iterations: against its
    unfused twin and generic preconditioned cg, launch counts, a bitwise
    repeat; at 1024^2 against a float64 CPU run; and a solve to 1e-6 beside
    unpreconditioned fused CG."""
    log(f"phase 7b: fused Jacobi CG at {BIG}^2, 100 iterations")
    iters, stable = 100, 5  # the lognormal field is held over 5 steps, as in phase 4
    stop = dict(tol=0.0, atol=0.0)
    totals = dict.fromkeys(cs.LAUNCHES, 0)
    A_smooth = st.diffusion_2d(smooth_field(BIG).astype(np.float32), device=dev)
    for label, A, steps in (("smooth a = 1 + 0.9 sin cos", A_smooth, iters),
                            ("lognormal a", A_div, stable)):
        b = torch.ones(A.grid, dtype=torch.float32, device=dev)
        fused, unfused, generic, n = jacobi_solves(A, b, kt, cs, iters, **stop)
        for k in totals:
            totals[k] += n[k]
        log(f"  {label}: launches {n}; resnorm ratio after {iters} "
            f"{fused.resnorms[-1] / fused.resnorms[0]:.4e}")
        assert fused.numsteps == iters
        assert n["cg_fused_phase_a_var_jac"] == n["cg_fused_phase_b_jac"] == iters
        assert n["cg_fused_phase_a_var"] == n["cg_fused_phase_b"] == 0
        assert bool(torch.isfinite(fused.xk).all()) and np.isfinite(fused.resnorms).all()
        agree(f"{label} fused Jacobi vs unfused", fused, unfused, steps)
        agree(f"{label} fused Jacobi vs generic cg(M=diag)", fused, generic, steps)
        _, again = kt.cg_stencil(A, b, maxiter=iters, fused=True, M="jacobi", **stop)
        same = np.array_equal(again.resnorms, fused.resnorms) and torch.equal(
            again.xk, fused.xk)
        log(f"  {label}: repeat bitwise equal: {same}")
        assert same
    del A_smooth

    log(f"  at {MID}^2: GPU f32 kernels against a CPU f64 run of the plain versions")
    a = np.exp(np.random.default_rng(SEED + 3).standard_normal((MID, MID)))
    for label, field, steps in (("smooth", smooth_field(MID), iters), ("lognormal", a, stable)):
        field = field.astype(np.float32)
        A_gpu = st.diffusion_2d(field, device=dev)
        A_cpu = st.diffusion_2d(field.astype(np.float64), device="cpu")
        b = torch.ones(A_gpu.grid, dtype=torch.float32, device=dev)
        _, g = kt.cg_stencil(A_gpu, b, maxiter=iters, fused=True, M="jacobi", **stop)
        _, ref = kt.cg_stencil(A_cpu, b.double().cpu(), maxiter=iters, M="jacobi", **stop)
        agree(f"{label} fused Jacobi f32 GPU vs f64 CPU", g, ref, steps)

    # to a tolerance, beside unpreconditioned fused CG: a manufactured
    # solution keeps the attainable f32 residual below the criterion
    _, b = manufactured(A_div, dev, SEED + 51)
    out = {}
    for name, M in (("Jacobi", "jacobi"), ("unpreconditioned", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = kt.cg_stencil(A_div, b, tol=1e-6, maxiter=4000, fused=True, M=M)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(b - A_div @ info.xk) / torch.linalg.norm(b))
        out[name] = info
        log(f"  lognormal {BIG}^2 to 1e-6, fused {name}: success {info.success} numsteps "
            f"{info.numsteps} in {time.perf_counter() - t0:.2f} s; explicit |b-Ax|/|b| {rel:.3e}")
    assert out["Jacobi"].success
    assert out["Jacobi"].numsteps <= out["unpreconditioned"].numsteps
    return totals


class Bf16Twin:
    """The CSROperator twin of a PETOperator with a bf16 value stream: the
    same bf16-rounded values kept in float32, float32 sums, ``dtype``
    bfloat16 (refine rounds the inner right-hand side to it)."""

    dtype = torch.bfloat16

    def __init__(self, sp, dev):
        from krylov_tpu_torch.ops.sparse import CSROperator

        rounded = sp.astype(np.float32).copy()
        rounded.data = torch.from_numpy(rounded.data).bfloat16().float().numpy()
        self.op = CSROperator.from_scipy(rounded, device=dev)
        self.shape, self.device = self.op.shape, self.op.device

    def __matmul__(self, x):
        return self.op @ x.float()

    def rmatvec(self, x):
        return self.op.rmatvec(x.float())


def family_solves(kt, dev, npg, b_seed, dtype=np.float32):
    """7c's solves on the reference bench's shifted Poisson CSR at side
    ``npg`` (its ``qmr`` call: Ml = Jacobi, tol 1e-4, maxiter 400,
    ``while_loop``), as {name: (matrix, solve)} like :func:`sparse_solves`."""
    from krylov_tpu_torch.ops.cuda_spmv import PETOperator
    from krylov_tpu_torch.ops.sparse import CSROperator

    lap = poisson_csr(npg).astype(dtype)
    rng = np.random.default_rng(b_seed)
    b = torch.from_numpy(rng.standard_normal(npg * npg).astype(dtype)).to(dev)
    B = torch.from_numpy(rng.standard_normal((npg * npg, 8)).astype(dtype)).to(dev)
    jac = kt.DiagonalOperator(torch.from_numpy(1.0 / lap.diagonal()).to(dev))
    kw = dict(tol=1e-4, maxiter=400, backend="while_loop")
    low = {}

    def refine(A):
        # the inner operator streams bf16 values: K10's bf16 mode for the
        # routed matrix, the same rounded values for the CSROperator twin
        twin = isinstance(A, CSROperator)
        if twin not in low:
            low[twin] = (Bf16Twin(lap, dev) if twin else PETOperator.from_scipy(
                lap, data_dtype=torch.bfloat16, with_rmatvec=False, device=dev))
        return kt.refine(A, b, A_low=low[twin], inner_tol=1e-2, inner_maxiter=100,
                         tol=1e-5, maxiter=20, backend="while_loop")

    cases = {
        "qmr Ml=Jacobi": (lap, lambda A: kt.qmr(A, b, Ml=jac, **kw)),
        "bicg M=Jacobi": (lap, lambda A: kt.bicg(A, b, M=jac, **kw)),
        "cgs M=Jacobi": (lap, lambda A: kt.cgs(A, b, M=jac, **kw)),
        "tfqmr M=Jacobi": (lap, lambda A: kt.tfqmr(A, b, M=jac, **kw)),
        "minres M=Jacobi": (lap, lambda A: kt.minres(A, b, M=jac, **kw)),
        "cg_pipelined M=Jacobi": (lap, lambda A: kt.cg_pipelined(A, b, M=jac, **kw)),
        "cg_block (N, 8)": (lap, lambda A: kt.cg_block(A, B, **kw)),
        "refine bf16 A_low": (lap, refine),
    }
    return cases, b


def phase_family(dev, kt, sv):
    """7c: the two-sided and the other new solvers on the bench's 1M-row
    shifted Poisson CSR through as_operator (K10 forward and adjoint, K11
    for cg_block, K10's bf16 mode for refine), with 6b's checks.  refine's
    last outer residual (a ratio near 5e-7) sits at the float32 residual's
    rounding floor: its twin is held over the outer steps before it, and
    its float64 CPU run, which keeps the bf16 inner operator (its plain
    version), over the first.  cg_pipelined recurs its residual norm as
    rr - 2 alpha rs + alpha^2 ss, which cancels as the solve converges:
    float32 is held to float64 over the first 10 steps."""
    log(f"phase 7c: the solver family on the {NPG}^2 shifted Poisson CSR")
    per_step = {"qmr": ("csr_matvec", 2), "bicg": ("csr_matvec", 2), "cgs": ("csr_matvec", 2),
                "tfqmr": ("csr_matvec", 1), "minres": ("csr_matvec", 1),
                "cg_pipelined": ("csr_matvec", 1), "cg_block": ("csr_matmat", 1),
                "refine": ("csr_matvec", 1)}
    launches, results = run_sparse_cases(
        dev, kt, sv, family_solves, (SEED + 52, SEED + 53),
        lambda name: per_step[name.split()[0]],
        f64_hold={"refine bf16 A_low": 1, "cg_pipelined M=Jacobi": 10},
        twin_hold={"refine bf16 A_low": 2})
    return launches, results


def phase_device_rule(kt, cs, sv, st):
    """7d: with no device argument anywhere, factories, right-hand sides and
    scipy matrices land on the card and the kernels run."""
    log("phase 7d: the device rule, no device argument anywhere")
    assert kt.default_device().type == "cuda"
    A = st.poisson_2d(64, dtype=np.float32)
    assert A.coeffs2d.is_cuda
    cs.reset_launches()
    x, info = kt.cg_stencil(A, np.ones(A.grid, np.float32), fused=True)
    torch.cuda.synchronize()
    log(f"  cg_stencil(poisson_2d(64), numpy b): success {info.success} numsteps "
        f"{info.numsteps} on {info.xk.device}; launches K5 "
        f"{cs.LAUNCHES['cg_fused_phase_a_var']} K4 {cs.LAUNCHES['cg_fused_phase_b']}")
    assert info.xk.is_cuda
    n5, n4 = cs.LAUNCHES["cg_fused_phase_a_var"], cs.LAUNCHES["cg_fused_phase_b"]
    assert n5 == n4 == info.numsteps > 0
    sp = poisson_csr(NPG)
    b = np.random.default_rng(SEED + 54).standard_normal(sp.shape[0]).astype(np.float32)
    sv.reset_launches()
    x, info = kt.bicgstab(sp, b, tol=1e-4, maxiter=400, backend="while_loop")
    torch.cuda.synchronize()
    log(f"  bicgstab(scipy CSR, numpy b): success {info.success} numsteps {info.numsteps} on "
        f"{info.xk.device}; K10 launches {sv.LAUNCHES['csr_matvec']}")
    assert info.success and info.xk.is_cuda and sv.LAUNCHES["csr_matvec"] > 0
    # an operator on the card and a CPU tensor are not brought together silently
    try:
        kt.cg_stencil(A, torch.ones(A.grid))
    except (RuntimeError, ValueError) as e:
        log(f"  a CPU tensor b with an operator on the card raises: {type(e).__name__}")
    else:
        raise AssertionError("a CPU b was moved to the card silently")


# ---------------------------------------------------------------------------
# phase 8: the stationary path (richardson, jacobi, the triangular sweeps,
# SSORSmoother, estimate_spectrum and ChebyshevPreconditioner)

STAT_STEPS = 20  # steps of richardson and jacobi at BIG^2
SWEEP_STEPS = 3  # steps of the sweep solvers at MID^2
NLEVEL = 1 << 20  # rows of the unstructured matrix of the level-scheduled route
SSOR_N = 256  # grid side of SSOR-preconditioned cg: a sweep is ~25 launches a grid row


def poisson_dia(n):
    """The 5-point Laplacian of ``poisson_2d(n)`` as a float64 scipy DIA
    matrix (no CSR of 84M entries at 4096^2)."""
    import scipy.sparse

    N = n * n
    side = -np.ones(N - 1)
    side[n - 1::n] = 0.0  # no coupling across grid rows
    far = -np.ones(N - n)
    return scipy.sparse.diags([far, side, 4.0 * np.ones(N), side, far], [-n, -1, 0, 1, n],
                              format="dia")


def unstructured_spd(n, k=4, seed=SEED + 60):
    """The reference tests' unstructured matrix, scaled up: ``k`` strictly
    lower neighbours a row drawn from all earlier rows (dependency depth
    O(log n)), symmetrized, diagonal in [4, 5]; float32 CSR."""
    import scipy.sparse

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), k)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    vals = 0.2 * rng.standard_normal(rows.shape[0])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()
    return A.astype(np.float32)


def host_stationary(A, b, update, steps):
    """``steps`` of ``x += update(r); r = b - A x`` on the host in float64:
    the residual norms."""
    x, r = np.zeros_like(b), b.copy()
    out = [np.linalg.norm(r)]
    for _ in range(steps):
        x += update(r)
        r = b - A @ x
        out.append(np.linalg.norm(r))
    return np.asarray(out)


def held(what, info, ref, rtol=TRAJ_RTOL):
    """The port's float32 residual history on the card against the float64
    host iteration of the same method, entry by entry at ``rtol`` (the
    file's trajectory band: float32 rounding in sums of up to 16.7M terms
    and in the sweeps' recurrences)."""
    got = np.asarray(info.resnorms, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.abs(got - ref) / ref
    log(f"  {what}: {info.numsteps} steps, resnorm ratio {got[-1] / got[0]:.4e}, max rel to "
        f"the float64 host iteration {rel.max():.3e} (rtol {rtol})")
    assert np.isfinite(got).all() and rel.max() <= rtol, what


def phase_stationary(dev, kt, cs, sv, st, card):
    """Phase 8.  Returns the launches of K1, K2 and K10 on these paths."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    from krylov_tpu_torch.ops.cuda_spmv import PETOperator
    from krylov_tpu_torch.ops.triangular import GridLowerSweep

    log(f"phase 8: the stationary path; richardson and jacobi on poisson_2d({BIG}) f32")
    totals = {"stencil2d_matvec": 0, "const_stencil2d_matvec": 0, "csr_matvec": 0}
    rng = np.random.default_rng(SEED + 61)
    kw = dict(tol=1e-30, backend="while_loop")

    A = st.poisson_2d(BIG, dtype=np.float32, device=dev)
    b64 = rng.standard_normal(BIG * BIG)
    b = torch.from_numpy(b64.astype(np.float32)).to(dev)
    b64 = b.double().cpu().numpy()
    A64 = poisson_dia(BIG)
    for name, okw, update in (
        ("richardson", dict(omega=0.2), lambda r: 0.2 * r),
        ("jacobi", dict(omega=0.9), lambda r: 0.9 * r / 4.0),
    ):
        solve = lambda: getattr(kt, name)(A, b, maxiter=STAT_STEPS, **okw, **kw)  # noqa: E731
        cs.reset_launches()
        sol, info = solve()
        torch.cuda.synchronize()
        n1 = cs.LAUNCHES["stencil2d_matvec"]
        assert sol is None and info.numsteps == STAT_STEPS and n1 == STAT_STEPS, (name, n1)
        assert info.xk.device == dev and bool(torch.isfinite(info.xk).all())
        totals["stencil2d_matvec"] += n1
        held(f"{name} {okw}, K1 launches {n1}", info, host_stationary(A64, b64, update,
                                                                        STAT_STEPS))
        wall, busy, rows = profiled(solve)
        log(f"  [{card}] {name} at {BIG}^2: {wall / STAT_STEPS * 1e6:.1f} us a step, device busy "
            f"{busy / STAT_STEPS * 1e6:.1f} us a step, idle share {1 - busy / wall:.3f}; "
            f"largest: " + "; ".join(
                f"{key[:32]} x{count:.0f} {us / 1e3:.2f} ms"
                for key, us, count in sorted(rows, key=lambda q: -q[1])[:3]))
    del A, A64, b, b64

    log(f"  the grid sweeps on poisson_2d({MID}) f32: gauss_seidel, sor, ssor, {SWEEP_STEPS} "
        f"steps each, against scipy's spsolve_triangular in float64")
    A = st.poisson_2d(MID, dtype=np.float32, device=dev)
    sp = poisson_dia(MID).tocsr()
    b = torch.from_numpy(rng.standard_normal(MID * MID).astype(np.float32)).to(dev)
    b64 = b.double().cpu().numpy()
    diag = sp.diagonal()

    def tri(lower, omega=1.0):
        t = (scipy.sparse.tril if lower else scipy.sparse.triu)(sp).tocsr()
        t.setdiag(diag / omega)
        return t

    def ssor_update(omega):
        lo, up = tri(True, omega), tri(False, omega)
        return lambda r: (2 - omega) / omega * spla.spsolve_triangular(
            up, diag * spla.spsolve_triangular(lo, r, lower=True), lower=False)

    low, upp, low13 = tri(True), tri(False), tri(True, 1.3)
    for name, okw, update in (
        ("gauss_seidel", {}, lambda r: spla.spsolve_triangular(low, r, lower=True)),
        ("gauss_seidel", dict(lower=False),
         lambda r: spla.spsolve_triangular(upp, r, lower=False)),
        ("sor", dict(omega=1.3), lambda r: spla.spsolve_triangular(low13, r, lower=True)),
        ("ssor", dict(omega=1.3), ssor_update(1.3)),
    ):
        cs.reset_launches()
        t0 = time.perf_counter()
        sol, info = getattr(kt, name)(A, b, maxiter=SWEEP_STEPS, **okw, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n1 = cs.LAUNCHES["stencil2d_matvec"]
        assert info.numsteps == n1 == SWEEP_STEPS and info.xk.device == dev, (name, n1)
        totals["stencil2d_matvec"] += n1
        held(f"{name} {okw} ({wall / SWEEP_STEPS:.2f} s a step)", info,
             host_stationary(sp, b64, update, SWEEP_STEPS))
    sweep = GridLowerSweep(A.coeffs2d, A.row_offsets, A.col_offsets)
    r2 = b.reshape(MID, MID)
    wall, busy, rows = profiled(lambda: sweep(r2))
    nlaunch = sum(q[2] for q in rows)
    log(f"  [{card}] one grid sweep at {MID}^2 (a Python loop over {MID} grid rows, "
        f"{len(sweep.a_steps)} doubling steps a row): {wall * 1e3:.1f} ms, {nlaunch:.0f} kernel "
        f"launches ({wall / nlaunch * 1e6:.1f} us of wall each), device busy {busy * 1e3:.1f} ms, "
        f"idle share {1 - busy / wall:.3f}")
    del A, sp, sweep

    log(f"  the level-scheduled sweeps: gauss_seidel on an unstructured {NLEVEL}-row CSR")
    sp = unstructured_spd(NLEVEL)
    b = torch.from_numpy(rng.standard_normal(NLEVEL).astype(np.float32)).to(dev)
    assert isinstance(kt.as_operator(sp, dev), PETOperator)
    sv.reset_launches()
    t0 = time.perf_counter()
    sol, info = kt.gauss_seidel(sp, b, tol=1e-4, maxiter=12, backend="while_loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n10 = sv.LAUNCHES["csr_matvec"]
    assert info.success and sol.device == dev and n10 == info.numsteps, (info.numsteps, n10)
    totals["csr_matvec"] += n10
    low = scipy.sparse.tril(sp.astype(np.float64)).tocsr()
    held(f"gauss_seidel, {sp.nnz} nnz, K10 launches {n10}, {wall:.2f} s with the level pass",
         info, host_stationary(sp.astype(np.float64), b.double().cpu().numpy(),
                               lambda r: spla.spsolve_triangular(low, r, lower=True),
                               info.numsteps))
    del sp, low

    log(f"  preconditioned cg on poisson_2d_const to 1e-6, b = A x*: Chebyshev (degree 8) "
        f"at {BIG}^2, SSOR at {SSOR_N}^2")
    for n, with_ssor in ((BIG, False), (SSOR_N, True)):
        A = st.poisson_2d_const(n, device=dev)
        xs, b = manufactured(A, dev, SEED + 62)
        cs.reset_launches()
        interval = kt.utils.estimate_spectrum(A)
        n_est = cs.LAUNCHES["const_stencil2d_matvec"]
        assert n_est == 30 and 0 < interval[0] < interval[1] < 8.5, (n_est, interval)
        totals["const_stencil2d_matvec"] += n_est
        log(f"  estimate_spectrum(poisson_2d_const({n})): ({interval[0]:.4e}, "
            f"{interval[1]:.4f}) from 30 Lanczos steps, K2 launches {n_est}")
        cases = [("plain", None, 0),
                 ("ChebyshevPreconditioner degree 8",
                  kt.ChebyshevPreconditioner(A, interval, degree=8), 8)]
        if with_ssor:
            cases.append(("SSORSmoother omega 1.8", kt.SSORSmoother(
                st.poisson_2d(n, dtype=np.float32, device=dev), omega=1.8), 0))
        for label, M, per_apply in cases:
            cs.reset_launches()
            t0 = time.perf_counter()
            x, info = kt.cg(A, b, M=M, inner=inner, tol=1e-6, maxiter=20000,
                            backend="while_loop")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n2 = cs.LAUNCHES["const_stencil2d_matvec"]
            totals["const_stencil2d_matvec"] += n2
            fwd = float(torch.linalg.norm(info.xk - xs) / torch.linalg.norm(xs))
            log(f"  [{card}] cg {label} at {n}^2: success {info.success}, {info.numsteps} "
                f"iterations, {wall * 1e3:.1f} ms, forward error {fwd:.3e}, K2 launches {n2} "
                f"(all tiled: {cs.K2_PATHS['tiled'] == n2})")
            # the explicit residual passed 1e-6 (success); the forward error is
            # bounded by the condition number times that, 7e6 at 4096^2
            assert info.success and fwd <= 0.1, label
            # an application before the loop and one a step, the step's own
            # product, and the explicit residual of the last check
            assert n2 >= (info.numsteps + 1) * per_apply + info.numsteps, (label, n2)
            if M is None:
                plain_steps = info.numsteps
            else:
                assert info.numsteps < plain_steps, label
    return totals


# ---------------------------------------------------------------------------
# phase 9: the sparse preconditioners (AMG on K10/K11 levels, ILU, block
# Jacobi) and their native host set-up

# the reference's cg_amg hierarchy on this matrix (BENCH_r04.json amg_levels)
REF_AMG_LEVELS = (1048576, 243204, 47345, 9573, 1702, 338)
PREC_NPG = 256  # grid side of the ILU solves and of line Jacobi
HOST_RTOL = 5e-4  # float64 host residual of a float32 solve to 1e-4
BJ_TOL = 1e-3  # block or point Jacobi cg on the unshifted poisson: float32 stalls short of 1e-4


def grid_csr(g, shift=0.0, conv=0.0):
    """The bench's 5-point (convected, shifted) Poisson on a true g x g grid,
    float32: no coupling across grid rows, so a triangular factor's levels
    are the wavefront, 2g - 1 (the bench's diags matrix couples each grid
    row's end to the next row's start: its triangles chain all n rows)."""
    import scipy.sparse

    n = g * g
    side = np.ones(n - 1)
    side[g - 1::g] = 0.0
    return scipy.sparse.diags([-np.ones(n - g), -(1.0 + conv) * side, (4.0 + shift) * np.ones(n),
                               -(1.0 - conv) * side, -np.ones(n - g)], [-g, -1, 0, 1, g],
                              format="csr", dtype=np.float32)


def aniso_csr(g, eps=100.0):
    """``tests/test_blockjacobi.py``'s anisotropic Poisson at side g: eps
    along the fast index, the direction a block of g rows spans; float32."""
    import scipy.sparse

    I = scipy.sparse.identity(g)
    T = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (scipy.sparse.kron(I, eps * T) + scipy.sparse.kron(T, I)).tocsr().astype(np.float32)


def host_residual(sp, b, x):
    """max over columns of ||b - A x|| / ||b||, in float64 on the host."""
    b64, x64 = b.double().cpu().numpy(), x.double().cpu().numpy()
    r = b64 - sp.astype(np.float64) @ x64
    return float(np.max(np.linalg.norm(r, axis=0) / np.linalg.norm(b64, axis=0)))


def pet_plain(sv, op, csr, v):
    """A PETOperator product by K10's plain version: the operator's own CSR
    (``op._csr`` or its adjoint's) between its permutation gathers."""
    v = v.float()
    if op._perm is not None:
        v = v.index_select(0, op._perm)
    y = sv.csr_matvec_plain(csr.indptr, csr.indices, csr.data, v)
    return y if op._inv_perm is None else y.index_select(0, op._inv_perm)


def cycle_launches(M, sv):
    """K10 launches one V(s, s) cycle of ``M`` makes: on a PETOperator level
    the smoothing (Jacobi: s - 1 products from zero and s after; Chebyshev:
    s and s + 1), the residual and two in the transfers; on a PETOperator
    prolongator two (forward and adjoint)."""
    per_level = 2 * M.smooth + (2 if M.smoother == "jacobi" else 4)
    return sum(per_level * isinstance(op, sv.PETOperator) + 2 * isinstance(p, sv.PETOperator)
               for op, p in zip(M._ops, M._phats))


def best_wall(fn, reps=3):
    """(best synchronized wall seconds of ``reps`` calls, the last result)."""
    best, out = 1e9, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def idle_line(card, what, fn):
    """Profile one call of ``fn`` and print its device busy time, idle share
    and kernel launches."""
    wall, busy, rows = profiled(fn)
    log(f"  [{card}] {what}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, idle "
        f"share {1 - busy / wall:.3f}, {sum(q[2] for q in rows):.0f} kernel launches; largest: "
        + "; ".join(f"{key[:32]} x{count:.0f} {us / 1e3:.2f} ms"
                    for key, us, count in sorted(rows, key=lambda q: -q[1])[:3]))


def phase_amg(dev, kt, sv, card, launches, errs):
    """9a-9c: the reference bench's cg_amg cell on the card."""
    from unittest import mock

    from krylov_tpu_torch import _operators
    from krylov_tpu_torch.ops import _native

    log(f"phase 9a: cg + AMG on the bench's unshifted poisson {NPG}^2 (bench.py's cg_amg)")
    rng = np.random.default_rng(SEED + 90)
    lap0 = poisson_csr(NPG, 4.0)
    n = lap0.shape[0]
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    Ap0 = sv.PETOperator.from_scipy(lap0, with_rmatvec=False, device=dev)
    torch.cuda.synchronize()
    fine_s = time.perf_counter() - t0
    _native.reset_native_paths()
    setups = []
    for _ in range(2):  # cold, then warm: what a user pays a matrix of a sequence
        t0 = time.perf_counter()
        M = kt.AMGPreconditioner.from_scipy(lap0, dtype=np.float32, fine_operator=Ap0,
                                            device=dev)
        torch.cuda.synchronize()
        setups.append(time.perf_counter() - t0)
    paths = {k: dict(v) for k, v in _native.NATIVE_PATHS.items()}
    log(f"  [{card}] amg_fine_op_build_s {fine_s:.3f}, amg_setup_cold_s {setups[0]:.3f}, "
        f"amg_setup_s {setups[1]:.3f}; phases of the warm set-up (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in M.setup_seconds.items()))
    log(f"  native set-up routes (two set-ups): {paths}")
    for helper in ("amg_pairwise_labels", "amg_rap"):
        assert paths[helper]["native"] > 0 and paths[helper]["numpy"] == 0, \
            f"{helper} fell back to numpy: the native build failed"
    assert M._ops[0] is Ap0
    log(f"  amg_levels {list(M.level_sizes)} (the reference on the TPU: {list(REF_AMG_LEVELS)}); "
        "level operators: " + ", ".join(
            f"{type(op).__name__}"
            + (f" ({op.nnz} nnz{', RCM' if getattr(op, '_perm', None) is not None else ''})"
               if hasattr(op, "nnz") else "") for op in M._ops)
        + "; prolongators: " + ", ".join(type(p).__name__ for p in M._phats))
    assert isinstance(M._ops[1], sv.PETOperator), "the first coarse level must take K10/K11"

    # K10 and K11 on every level and prolongator the cycle routes to them
    for label, op in ([(f"level {i}", o) for i, o in enumerate(M._ops)]
                      + [(f"P_hat {i}", p) for i, p in enumerate(M._phats)]):
        if not isinstance(op, sv.PETOperator):
            continue
        sides = [(False, op._csr)] + ([(True, op._csr_t)] if op._csr_t is not None else [])
        for adjoint, csr in sides:
            m = csr.shape[1]
            for v, key in ((torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev),
                            "csr_matvec"),
                           (torch.from_numpy(rng.standard_normal((m, 8)).astype(np.float32))
                            .to(dev), "csr_matmat")):
                got = op.rmatvec(v) if adjoint else op @ v
                torch.cuda.synchronize()
                errs[key] = max(errs[key], rel_close(
                    f"{'K10' if v.ndim == 1 else 'K11 k=8'} AMG {label}"
                    f"{' adjoint' if adjoint else ''} {csr.shape}", got,
                    pet_plain(sv, op, csr, v), 1e-5))

    # the same hierarchy on plain CSR levels: one cycle of each at the f32 band
    with mock.patch.object(_operators, "_pet_device", lambda device: False):
        plain = kt.AMGPreconditioner.from_scipy(lap0, dtype=np.float32, device=dev)
    assert plain.level_sizes == M.level_sizes
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    R = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(dev)
    rel_close("V-cycle on K10 levels vs plain CSR levels", M @ r, plain @ r, 1e-4)
    rel_close("V-cycle on K11 levels vs plain CSR levels, k=8", M @ R, plain @ R, 1e-4)
    del plain

    per_cycle = cycle_launches(M, sv)
    sv.reset_launches()
    M @ r
    torch.cuda.synchronize()
    assert sv.LAUNCHES["csr_matvec"] == per_cycle, (dict(sv.LAUNCHES), per_cycle)

    def solve(B, Mx=M):
        return kt.cg(Ap0, B, M=Mx, tol=1e-4, maxiter=60, backend="while_loop")

    for smoother in ("jacobi", "chebyshev"):
        Mx = M if smoother == "jacobi" else kt.AMGPreconditioner.from_scipy(
            lap0, dtype=np.float32, fine_operator=Ap0, smoother="chebyshev", device=dev)
        per = cycle_launches(Mx, sv)
        sv.reset_launches()
        _, info = solve(b, Mx)
        torch.cuda.synchronize()
        n10 = sv.LAUNCHES["csr_matvec"]
        res = host_residual(lap0, b, info.xk)
        log(f"  cg + AMG ({smoother}): success {info.success}, {info.numsteps} iterations, "
            f"K10 launches {n10} ({per} a V-cycle), float64 host residual {res:.3e} "
            f"(bound {HOST_RTOL:g})")
        assert info.success and res <= HOST_RTOL, smoother
        assert n10 >= (info.numsteps + 1) * per + info.numsteps, (n10, per)
        launches["csr_matvec"] += n10
        wall, (_, again) = best_wall(lambda: solve(b, Mx))
        log(f"  [{card}] cg_amg_ms {wall * 1e3:.2f} ({smoother}; best of 3), cg_amg_iters "
            f"{again.numsteps}, cg_amg_converged {again.success}")
        idle_line(card, f"cg + AMG ({smoother})", lambda: solve(b, Mx))
        if smoother == "jacobi":
            idle_line(card, "one V-cycle", lambda: M @ r)
    del Mx

    log(f"  blocked right-hand side ({n}, 8): K11 on every level")
    B = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(dev)
    sv.reset_launches()
    _, info = solve(B)
    torch.cuda.synchronize()
    n11 = sv.LAUNCHES["csr_matmat"]
    res = host_residual(lap0, B, info.xk)
    log(f"  cg + AMG, k=8: success {info.success}, {info.numsteps} iterations, K11 launches "
        f"{n11}, K10 launches {sv.LAUNCHES['csr_matvec']}, float64 host residual (worst "
        f"column) {res:.3e}")
    assert info.success and res <= HOST_RTOL and n11 >= (info.numsteps + 1) * per_cycle
    launches["csr_matmat"] += n11
    wall, _ = best_wall(lambda: solve(B))
    log(f"  [{card}] cg + AMG k=8: {wall * 1e3:.2f} ms (best of 3)")
    return lap0, Ap0, b


def phase_ilu(dev, kt, sv, card, launches):
    """9d: ILU(0) solves at PREC_NPG^2 and the set-up at NPG^2 with both
    level passes."""
    from unittest import mock

    from krylov_tpu_torch.ops import _native
    from krylov_tpu_torch.ops import triangular as tri

    g = PREC_NPG
    log(f"phase 9d: ILU(0) at {g}^2 (true grids: convected shifted poisson, unshifted poisson)")
    rng = np.random.default_rng(SEED + 91)
    conv, spd = grid_csr(g, 0.5, 0.4), grid_csr(g)
    b = torch.from_numpy(rng.standard_normal(g * g).astype(np.float32)).to(dev)
    _native.reset_native_paths()
    t0 = time.perf_counter()
    Mconv = kt.ILUPreconditioner.from_scipy(conv, device=dev)
    Mspd = kt.ILUPreconditioner.from_scipy(spd, device=dev)
    torch.cuda.synchronize()
    log(f"  [{card}] two ILU(0) set-ups at {g}^2: {time.perf_counter() - t0:.3f} s; levels "
        f"{Mconv.nlevels}, {Mspd.nlevels}; native routes {_native.NATIVE_PATHS}")
    for helper in ("ilu0_factor", "tri_levels"):
        assert _native.NATIVE_PATHS[helper]["numpy"] == 0, f"{helper} fell back to numpy"
    want = kt.ILUPreconditioner.from_scipy(conv, device="cpu") @ b.cpu()
    rel_close("ILU(0) application on the card vs the CPU", Mconv @ b, want.to(dev), 1e-4)
    idle_line(card, f"one ILU(0) application ({sum(Mconv.nlevels)} levels)", lambda: Mconv @ b)
    for label, sp, solver, key, M, maxiter in (
        ("bicgstab Ml=ILU(0)", conv, kt.bicgstab, "Ml", Mconv, 200),
        ("gmres Ml=ILU(0)", conv, kt.gmres, "Ml", Mconv, 120),
        ("cg M=ILU(0)", spd, kt.cg, "M", Mspd, 400),
    ):
        assert isinstance(kt.as_operator(sp, dev), sv.PETOperator)
        op = kt.as_operator(sp, dev)
        sv.reset_launches()
        t0 = time.perf_counter()
        _, info = solver(op, b, tol=1e-4, maxiter=maxiter, backend="while_loop", **{key: M})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = host_residual(sp, b, info.xk)
        n10 = sv.LAUNCHES["csr_matvec"]
        log(f"  [{card}] {label}: success {info.success}, {info.numsteps} iterations, "
            f"{wall * 1e3:.1f} ms, K10 launches {n10}, float64 host residual {res:.3e}")
        assert info.success and res <= HOST_RTOL and n10 >= info.numsteps, label
        launches["csr_matvec"] += n10
    del Mconv, Mspd

    big = grid_csr(NPG)
    times = {}
    for route in ("native", "numpy"):
        with mock.patch.object(tri._native, "tri_levels_native",
                               tri._native.tri_levels_native if route == "native"
                               else (lambda sp, lower: None)):
            t0 = time.perf_counter()
            Mb = kt.ILUPreconditioner.from_scipy(big, device=dev)
            torch.cuda.synchronize()
            times[route] = (time.perf_counter() - t0, Mb)
    (tn, Mn), (tp, Mp) = times["native"], times["numpy"]
    assert Mn.nlevels == Mp.nlevels == (2 * NPG - 1, 2 * NPG - 1)
    assert torch.equal(Mn._l.rows, Mp._l.rows) and torch.equal(Mn._u.lrow, Mp._u.lrow)
    log(f"  [{card}] ILU(0) set-up at {NPG}^2 ({big.shape[0]} rows, {Mn.nlevels} levels): "
        f"{tn:.3f} s with the native level pass, {tp:.3f} s with the numpy frontier pass")


def phase_block_jacobi(dev, kt, sv, card, launches, lap0, Ap0, b):
    """9e: block Jacobi (block=64) against point Jacobi on the bench's
    unshifted poisson, and line against point Jacobi on an anisotropic
    poisson.  On the unshifted poisson a float32 cg stalls short of 1e-4 of
    |b| (the bench's 1500-step Jacobi cell never gets there), so these
    solves go to BJ_TOL."""
    log(f"phase 9e: block Jacobi (block=64) and point Jacobi as M of cg on the unshifted "
        f"poisson {NPG}^2, to {BJ_TOL:g}")
    t0 = time.perf_counter()
    Mb = kt.BlockJacobiPreconditioner.from_scipy(lap0, block=64, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 92)
    r = torch.from_numpy(rng.standard_normal(lap0.shape[0]).astype(np.float32)).to(dev)
    want = kt.BlockJacobiPreconditioner.from_scipy(lap0, block=64, device="cpu") @ r.cpu()
    rel_close("block Jacobi application on the card vs the CPU", Mb @ r, want.to(dev), 1e-5)
    log(f"  [{card}] block Jacobi set-up {setup:.3f} s ({Mb._inv.shape[0]} inverses of 64^2, "
        f"{Mb._inv.numel() * 4 / 1e6:.0f} MB)")
    # one batched product: CUDA events around a loop and a replayed graph
    # (the profiler records no kernel of it on this card's stack)
    loop, graph = time_ms(lambda: Mb @ r, 20), graph_ms(lambda: Mb @ r)
    log(f"  [{card}] one block-Jacobi application: {graph * 1e3:.1f} us in a CUDA graph, "
        f"{loop * 1e3:.1f} us in a Python loop (bound "
        f"{(Mb._inv.numel() + 2 * r.numel()) * 4 / HBM_BYTES_PER_S * 1e6:.1f} us: the "
        f"inverses and two vectors once)")
    point = kt.DiagonalOperator(torch.from_numpy(1.0 / lap0.diagonal()).to(dev))
    for label, M in (("block", Mb), ("point", point)):
        sv.reset_launches()
        t0 = time.perf_counter()
        _, info = kt.cg(Ap0, b, M=M, tol=BJ_TOL, maxiter=3000, backend="while_loop")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n10 = sv.LAUNCHES["csr_matvec"]
        res = host_residual(lap0, b, info.xk)
        log(f"  [{card}] cg + {label} Jacobi: success {info.success}, {info.numsteps} "
            f"iterations, {wall * 1e3:.1f} ms ({wall / info.numsteps * 1e6:.1f} us a step), K10 "
            f"launches {n10}, float64 host residual {res:.3e}")
        assert n10 >= info.numsteps, label
        if label == "block":  # point Jacobi is printed beside it, not held
            assert info.success and res <= 5 * BJ_TOL, label
        launches["csr_matvec"] += n10
    del Mb

    g = PREC_NPG
    log(f"  line Jacobi (block = {g}) against point Jacobi on the anisotropic poisson {g}^2, "
        f"eps 100 along the lines, to 1e-4")
    an = aniso_csr(g)
    op = kt.as_operator(an, dev)
    assert isinstance(op, sv.PETOperator)
    b2 = torch.from_numpy(rng.standard_normal(g * g).astype(np.float32)).to(dev)
    steps = {}
    for label, M in (("line", kt.BlockJacobiPreconditioner.from_scipy(an, block=g, device=dev)),
                     ("point", kt.DiagonalOperator(
                         torch.from_numpy(1.0 / an.diagonal()).to(dev)))):
        sv.reset_launches()
        t0 = time.perf_counter()
        _, info = kt.cg(op, b2, M=M, tol=1e-4, maxiter=20000, backend="while_loop")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = host_residual(an, b2, info.xk)
        steps[label] = info.numsteps
        log(f"  [{card}] cg + {label} Jacobi: success {info.success}, {info.numsteps} "
            f"iterations, {wall * 1e3:.1f} ms, float64 host residual {res:.3e}")
        launches["csr_matvec"] += sv.LAUNCHES["csr_matvec"]
        if label == "line":  # point Jacobi may stall short of 1e-4 in float32
            assert info.success and res <= HOST_RTOL, label
    assert steps["line"] * 4 < steps["point"], steps


def phase_preconditioners(dev, kt, sv, card):
    """Phase 9.  Returns the launches of K10 and K11 on its paths and the
    worst errors of its kernel checks."""
    launches = {"csr_matvec": 0, "csr_matmat": 0}
    errs = {"csr_matvec": 0.0, "csr_matmat": 0.0}
    lap0, Ap0, b = phase_amg(dev, kt, sv, card, launches, errs)
    phase_block_jacobi(dev, kt, sv, card, launches, lap0, Ap0, b)
    del Ap0
    phase_ilu(dev, kt, sv, card, launches)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 10: differentiable solves (diffable) and profiling

DIFF_TOL = 1e-6  # the forward and adjoint solves' tolerance at BIG^2, float32
FD_BAND = 5e-2  # the reference's own on-chip band for a directional derivative
ADJ_RES = 1e-4  # float64 host residual of the float32 adjoint solution
DIFF_F64_TOL = 1e-11  # the float64 solves at MID^2
FD_BAND_F64 = 1e-5


def lognormal_field(n, seed):
    return np.exp(np.random.default_rng(seed).standard_normal((n, n)))


def f64_loss(w, x):
    """``<w, x>`` summed in float64 on the device."""
    return (w.double() * x.double()).sum()


def stencil_gradient_case(dev, kt, cs, st, field, dtype, tol, maxiter, eps, seed, card):
    """diffable.solve (cg, Jacobi M) on ``diffusion_2d(field)`` in ``dtype``
    with ``b = A x*`` and the loss ``<w, x>``, ``w = A w*``: the wall times of the forward
    and the backward pass, the share of the backward that is the parameter
    VJP, the adjoint residual of ``b``'s gradient in float64 on the host,
    and the coefficient gradient's directional derivative along a
    symmetric direction (``diffusion_2d(field * z)``: the coefficients are
    linear in the field) against a central difference of step ``eps``.
    Returns K1's launches in the forward and backward passes, the relative
    difference and the VJP's share."""
    n = field.shape[0]
    A0 = st.diffusion_2d(field.astype(dtype), device=dev)
    M = kt.jacobi_preconditioner(A0)
    rng = np.random.default_rng(seed)
    xs, ws = (torch.from_numpy(rng.standard_normal(n * n).astype(dtype)).to(dev)
              for _ in range(2))
    # w = A ws: the adjoint solution is ws, as rough as x*, so the float32
    # adjoint solve reaches 1e-6 as the forward one does (for a white-noise
    # w, A^-1 w is smooth and large, and float32 stalls near 5e-5)
    b, w = (A0 @ v for v in (xs, ws))
    b.requires_grad_()
    c = A0.coeffs2d.detach().clone().requires_grad_()
    A = st.GridStencilOperator(c, None, A0.ny, hermitian=True,
                               row_col_offsets=(A0.row_offsets, A0.col_offsets))
    kw = dict(M=M, tol=tol, maxiter=maxiter)
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = kt.diffable.solve(A, b, **kw)
    loss = f64_loss(w, x)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    n_fwd = cs.LAUNCHES["stencil2d_matvec"]
    # the backward's adjoint solve alone, on this thread
    t0 = time.perf_counter()
    _, adj_info = kt.cg(A0, w, backend="while_loop", **kw)
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    cs.reset_launches()
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    n_bwd = cs.LAUNCHES["stencil2d_matvec"]
    lam = b.grad
    # the parameter VJP alone, as the backward pass runs it
    t0 = time.perf_counter()
    with torch.enable_grad():
        leaf = c.detach().requires_grad_()
        y = st.GridStencilOperator(leaf, None, A0.ny, hermitian=True,
                                   row_col_offsets=(A0.row_offsets, A0.col_offsets)) @ x.detach()
        vjp = torch.autograd.grad((y * -lam).sum(), leaf)[0]
    torch.cuda.synchronize()
    t_vjp = time.perf_counter() - t0
    assert torch.equal(vjp, c.grad)
    x_err = float(torch.linalg.norm(x.detach().double() - xs.double()) / torch.linalg.norm(xs.double()))

    # b's gradient: the adjoint residual ||A^H lam - w|| / ||w|| in float64 on the host
    Ah = st.GridStencilOperator(c.detach().double().cpu(), None, A0.ny, hermitian=True,
                                row_col_offsets=(A0.row_offsets, A0.col_offsets))
    w64 = w.double().cpu()
    adj = float(torch.linalg.norm(Ah @ lam.double().cpu() - w64) / torch.linalg.norm(w64))
    del Ah

    z = np.random.default_rng(seed + 1).standard_normal(field.shape)
    direction = st.diffusion_2d((field * z).astype(dtype), device=dev).coeffs2d
    got = float((c.grad.double() * direction.double()).sum())
    scale = float((c.grad.double() * c.detach().double()).sum())  # d/ds L(s c) = -L

    def loss_at(cc):
        with torch.no_grad():
            A_ = st.GridStencilOperator(cc, None, A0.ny, hermitian=True,
                                        row_col_offsets=(A0.row_offsets, A0.col_offsets))
            return float(f64_loss(w, kt.diffable.solve(A_, b.detach(), **kw)))

    cd = c.detach()
    fd = (loss_at(cd + eps * direction) - loss_at(cd - eps * direction)) / (2 * eps)
    rel = abs(got - fd) / abs(fd)
    loss = float(loss.detach())
    rel_scale = abs(scale + loss) / abs(loss)
    share = t_vjp / t_bwd
    log(f"  [{card}] diffusion_2d({n}) {np.dtype(dtype).name}, cg + Jacobi to {tol:g}: "
        f"forward {t_fwd * 1e3:.1f} ms ({n_fwd} K1 launches), backward {t_bwd * 1e3:.1f} ms "
        f"({n_bwd} K1 launches), parameter VJP {t_vjp * 1e3:.2f} ms = {share:.4f} of the "
        f"backward; the adjoint solve alone {t_adj * 1e3:.1f} ms ({adj_info.numsteps} steps); "
        f"|x - x*|/|x*| {x_err:.3e}")
    log(f"  float64 host adjoint residual |A^H lam - w|/|w| {adj:.3e}; directional "
        f"derivative {got:.8e} vs central difference (eps {eps:g}) {fd:.8e}: rel {rel:.3e}; "
        f"<grad, c> {scale:.8e} vs -L {-loss:.8e}: rel {rel_scale:.3e}")
    assert n_bwd > 0 and n_fwd > 0
    return n_fwd + n_bwd, rel, rel_scale, adj, share


def phase_diffable(dev, kt, cs, sv, bs, st, A_div, card):
    """Phase 10.  Returns the launches of K1, K10 and K12 on its paths."""
    import glob
    import json
    import os
    import tempfile

    launches = dict.fromkeys(("stencil2d_matvec", "csr_matvec", "bsr_spmm"), 0)
    log(f"phase 10a: diffable.solve on the lognormal diffusion_2d({BIG}) (K1 forward, "
        "adjoint and gradient)")
    field = lognormal_field(BIG, SEED + 1)  # A_div's field
    n, rel, rel_scale, adj, _ = stencil_gradient_case(
        dev, kt, cs, st, field, np.float32, DIFF_TOL, 5000, 1e-2, SEED + 70, card)
    launches["stencil2d_matvec"] += n
    assert rel <= FD_BAND and rel_scale <= FD_BAND and adj <= ADJ_RES, (rel, rel_scale, adj)
    del field
    log(f"  at {MID}^2 in float64 on the card")
    n, rel, rel_scale, adj, _ = stencil_gradient_case(
        dev, kt, cs, st, lognormal_field(MID, SEED + 71), np.float64, DIFF_F64_TOL, 20000,
        1e-4, SEED + 72, card)
    launches["stencil2d_matvec"] += n
    assert rel <= FD_BAND_F64 and rel_scale <= FD_BAND_F64 and adj <= 1e-8, (rel, rel_scale, adj)

    log(f"phase 10b: K1's gradient at {BIG}^2 against autograd through its plain version")
    rng = np.random.default_rng(SEED + 73)
    ro, co = A_div.row_offsets, A_div.col_offsets
    x = torch.from_numpy(rng.standard_normal((BIG, BIG)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((BIG, BIG)).astype(np.float32)).to(dev)
    grads, secs = [], []
    for fn in (cs.stencil2d_matvec, cs.stencil2d_matvec_plain):
        cl, xl = A_div.coeffs2d.clone().requires_grad_(), x.clone().requires_grad_()
        y = fn(cl, xl, ro, co)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (y * w).sum().backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        grads.append((cl.grad, xl.grad))
    for name, got, want in zip(("coefficients", "x"), *grads):
        check_close(f"K1 gradient to {name}, {BIG}^2 f32", got, want,
                    atol=1e-5 * float(want.abs().max()))
    log(f"  [{card}] backward wall: Function (K1 adjoint + torch) {secs[0] * 1e3:.2f} ms, "
        f"autograd through the plain version {secs[1] * 1e3:.2f} ms")
    del grads, x, w

    log(f"phase 10c: gmres through the {NPG}^2 convected CSR (PETOperator: K10 forward and "
        "adjoint)")
    sp = convected_csr(NPG)
    A = kt.as_operator(sp, dev)
    assert type(A).__name__ == "PETOperator"
    rng = np.random.default_rng(SEED + 74)
    b = torch.from_numpy(rng.standard_normal(sp.shape[0]).astype(np.float32)).to(dev)
    b.requires_grad_()
    w = torch.from_numpy(rng.standard_normal(sp.shape[0]).astype(np.float32)).to(dev)
    sv.reset_launches()
    x = kt.diffable.solve(A, b, solver=kt.gmres, tol=1e-5, maxiter=200)
    loss = f64_loss(w, x)
    torch.cuda.synchronize()
    n_fwd = sv.LAUNCHES["csr_matvec"]
    loss.backward()
    torch.cuda.synchronize()
    n_bwd = sv.LAUNCHES["csr_matvec"] - n_fwd
    launches["csr_matvec"] += n_fwd + n_bwd
    sp64 = sp.astype(np.float64)
    b64, x64, w64 = (t.detach().double().cpu().numpy() for t in (b, x, w))
    lam = b.grad.double().cpu().numpy()
    fwd = np.linalg.norm(b64 - sp64 @ x64) / np.linalg.norm(b64)
    adj = np.linalg.norm(sp64.T @ lam - w64) / np.linalg.norm(w64)
    log(f"  K10 launches: forward {n_fwd}, backward {n_bwd} (the adjoint's CSR); float64 "
        f"host residuals: forward {fwd:.3e}, adjoint |A^T lam - w|/|w| {adj:.3e}")
    assert n_fwd > 0 and n_bwd > 0 and fwd <= 1e-4 and adj <= 1e-4
    del A, x, b

    log(f"phase 10d: default leaves of the 6c BSROperator ({NBLK} blocks of 32x32; K12 and "
        "its data gradient)")
    from krylov_tpu_torch.ops.bsr import BSROperator

    sp = block_spd_csr()
    routed = kt.as_operator(sp, dev)
    assert type(routed).__name__ == "BSROperator"
    data = routed.data.detach().clone().requires_grad_()
    A = BSROperator(data, routed.cols, routed.shape)
    b = torch.from_numpy(rng.standard_normal(sp.shape[0]).astype(np.float32)).to(dev)
    b.requires_grad_()
    w = torch.from_numpy(rng.standard_normal(sp.shape[0]).astype(np.float32)).to(dev)
    bs.reset_launches()
    x = kt.diffable.solve(A, b, tol=1e-5, maxiter=300)
    loss = f64_loss(w, x)
    loss.backward()
    torch.cuda.synchronize()
    launches["bsr_spmm"] += bs.LAUNCHES["bsr_spmm"]
    with torch.enable_grad():
        leaf = data.detach().requires_grad_()
        y = bs.bsr_spmm_plain(leaf, A.cols, x.detach()[:, None])
        want = torch.autograd.grad((y * -b.grad[:, None]).sum(), leaf)[0]
    check_close("K12 data gradient on the solve's x and lambda", data.grad, want,
                atol=1e-5 * float(want.abs().max()))
    scale = float((data.grad.double() * data.detach().double()).sum())
    loss = float(loss.detach())
    rel_scale = abs(scale + loss) / abs(loss)
    log(f"  K12 launches {bs.LAUNCHES['bsr_spmm']}; <grad, data> {scale:.8e} vs -L "
        f"{-loss:.8e}: rel {rel_scale:.3e}")
    assert bs.LAUNCHES["bsr_spmm"] > 0 and rel_scale <= FD_BAND
    del A, data, x, b

    log("phase 10e: profiling on the card")
    peak = kt.profiling.peak_gbps()
    xg = torch.from_numpy(np.random.default_rng(SEED + 75).standard_normal((BIG, BIG))
                          .astype(np.float32)).to(dev)
    ms = time_ms(lambda: A_div @ xg, 20)
    rep = kt.profiling.roofline_report(A_div, ms * 1e-3)
    log(f"  [{card}] K1 at {BIG}^2: {ms * 1e3:.1f} us; roofline_report {rep}")
    assert np.isfinite(peak) and 0.0 < rep["fraction_of_roofline"] <= 1.0, rep
    with tempfile.TemporaryDirectory() as logdir:
        bg = torch.ones(A_div.grid, dtype=torch.float32, device=dev)
        with kt.profiling.trace(logdir):
            kt.cg(A_div, bg, inner=inner, tol=0.0, atol=0.0, maxiter=10, backend="while_loop")
            torch.cuda.synchronize()
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
    k1 = [nm for nm in names if "stencil2d_kernel" in nm]
    log(f"  profiling.trace around cg (10 iterations): {size} bytes, {len(names)} kernel "
        f"events, {len(k1)} of K1 ({k1[0][:60] if k1 else 'none'})")
    assert len(k1) >= 10
    return launches

# ---------------------------------------------------------------------------
# phase 11: the distribution layer
# ---------------------------------------------------------------------------

DIST_STEPS = 300  # fixed steps of 11a at BIG^2
DIST_REPEATS = 5  # timed solves of each of 11a's runs, alternating
DIST_JAC_STEPS = 1500  # fixed steps of 11a's sharded cg + Jacobi on the 1M-row CSR
GLOO_RANKS = 4
GLOO_N = 1024  # 11b's grid side: 256 grid rows a rank
GLOO_STEPS = 50  # fixed steps of 11b's solves
GLOO_NPG = 256  # 11b's sparse matrices: 65,536 rows


F32_FLOOR = 1e-4  # below this share of the first residual, f32 histories part


def sharded_held(what, got, ref, x_got=None, x_ref=None):
    """A sharded f32 solve against its single-device twin: equal numsteps
    and the history within the reference's f32 band for sharded runs over
    the steps whose residual is above F32_FLOOR of the first (below it two
    float32 histories part at the float32 floor, as two orders of summation
    do), finite iterates."""
    steps, hist = got
    rel = np.abs(hist - ref.resnorms) / np.abs(ref.resnorms)
    live = np.abs(ref.resnorms) >= F32_FLOOR * np.abs(ref.resnorms[0])
    held = rel[live].max()
    log(f"  {what}: numsteps {steps} (single {ref.numsteps}), max rel resnorm {held:.3e} "
        f"over the {int(live.all(axis=tuple(range(1, live.ndim))).sum())} steps above "
        f"{F32_FLOOR:g} of r0 (rtol {TRAJ_RTOL}); {rel.max():.3e} over all")
    assert steps == ref.numsteps and held <= TRAJ_RTOL, what
    if x_got is not None:
        assert np.isfinite(x_got).all()
        err = float(np.abs(x_got - x_ref).max() / max(np.abs(x_ref).max(), 1e-30))
        log(f"    iterate max rel err against single {err:.3e}")
    return held


def phase_distributed_one(dev, kt, cs, sv, bs, st, card):
    """11a: ``sharded_solve`` on one NCCL rank, at full width.  The rank is
    alone on its mesh, so the mesh launches no collective: ``cg`` at
    ``BIG^2`` takes the route and makes the kernel launches of the
    single-device solve beside it, in the same time within the spread
    (``DIST_REPEATS`` solves of each, alternating).  Then phase 13's ``cg``
    + Jacobi cell sharded (``sharded_solve(M_diag=)`` on the PET partition
    of the unshifted 1M-row CSR, ``DIST_JAC_STEPS`` fixed steps) through
    :func:`route_cell`: the rule's route captures and is bit-equal to the
    host-stepped loop."""
    import torch.distributed as dist

    from krylov_tpu_torch import _driver, parallel
    from krylov_tpu_torch.parallel import mesh as pm

    log(f"phase 11a: sharded_solve on a world of one rank (NCCL) at {BIG}^2, "
        f"{DIST_STEPS} steps, against single-device cg [{card}]")
    mesh = parallel.make_mesh(device=dev)  # starts the world through a file:// store
    assert dist.get_world_size() == 1 and not mesh.staged
    assert dev.type != "cuda" or "nccl" in dist.get_backend()
    launches = {}
    try:
        for label, A, kernel in (
            ("poisson_2d", st.poisson_2d(BIG, dtype=np.float32, device=dev), "stencil2d_matvec"),
            ("poisson_2d_const", st.poisson_2d_const(BIG, dtype=np.float32, device=dev),
             "const_stencil2d_matvec"),
        ):
            b = torch.ones(A.grid, dtype=torch.float32, device=dev)
            x0 = torch.zeros_like(b)  # as the sharded solve's slab: r0 = b - A x0, one matvec
            runs = {
                "single": lambda it: kt.cg(A, b, inner=inner, x0=x0, tol=0.0, atol=0.0,
                                           maxiter=it, backend="while_loop"),
                "sharded": lambda it: parallel.sharded_solve(kt.cg, A, b, mesh=mesh, tol=0.0,
                                                             atol=0.0, maxiter=it),
            }
            infos, walls, seen = {}, {n: [] for n in runs}, {n: [] for n in runs}
            for name, run in runs.items():
                run(5)  # warm
            for rep in range(DIST_REPEATS):
                for name in list(runs)[::1 if rep % 2 == 0 else -1]:
                    torch.cuda.synchronize()
                    cs.reset_launches()
                    pm.reset_counts()
                    _driver.reset_counts()
                    t0 = time.perf_counter()
                    _, infos[name] = runs[name](DIST_STEPS)
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
                    seen[name].append((cs.LAUNCHES[kernel], sum(pm.COUNTS.values()),
                                       _driver.COUNTS["graph_route"], _driver.COUNTS["captures"]))
                    if name == "sharded":
                        for k, v in cs.LAUNCHES.items():
                            launches[k] = launches.get(k, 0) + v
            got = infos["sharded"]
            sharded_held(f"{label} sharded vs single", (got.numsteps, got.resnorms),
                         infos["single"])
            x_err = max_err(got.xk, infos["single"].xk) / float(infos["single"].xk.abs().max())
            med = {n: float(np.median(w)) / DIST_STEPS * 1e6 for n, w in walls.items()}
            spread = {n: (max(w) - min(w)) / DIST_STEPS * 1e6 for n, w in walls.items()}
            log(f"  [{card}] {label}: {med['single']:.1f} us/iter single (spread "
                f"{spread['single']:.1f}), {med['sharded']:.1f} us/iter sharded on one rank "
                f"(spread {spread['sharded']:.1f}), medians of {DIST_REPEATS} alternating, "
                f"difference {med['sharded'] - med['single']:+.1f} us/iter; iterate rel err "
                f"{x_err:.3e}")
            for name in runs:
                n_k, n_c, n_g, n_cap = (list(v) for v in zip(*seen[name]))
                log(f"  {label} {name}, each solve: {kernel} launches {n_k}, collectives {n_c} "
                    f"({sum(n_c) / DIST_STEPS / DIST_REPEATS:.2f} a step), graph route {n_g}, "
                    f"captures {n_cap}")
            launched = [n for n, _, _, _ in seen["sharded"]]
            assert not any(c for _, c, _, _ in seen["sharded"]), seen["sharded"]
            assert launched == [n for n, _, _, _ in seen["single"]], (label, seen)
            assert min(launched) >= DIST_STEPS
            assert np.isfinite(got.resnorms).all()
            assert med["sharded"] <= med["single"] + max(spread.values()), (label, med, spread)
            # the slab's matvec; a reduction, which launches nothing on one rank
            A_l = (parallel.ShardedConstStencilOperator(A, BIG, mesh) if kernel.startswith("const")
                   else parallel.ShardedGridStencilOperator(A.coeffs2d, A.offsets, A.ny, mesh,
                                                            hermitian=True))
            one = torch.ones((), dtype=torch.float32, device=dev)
            mv, mv_l = time_ms(lambda: A @ b, 50), time_ms(lambda: A_l @ b, 50)
            ar = time_ms(lambda: mesh.all_reduce(one), 200)
            log(f"  {label}: a loop of matvecs {mv * 1e3:.1f} us single, {mv_l * 1e3:.1f} us "
                f"the one-rank slab's; a loop of all_reduce on a scalar {ar * 1e3:.1f} us a call")
            del A, A_l, b, x0, infos, got

        lap0 = poisson_csr(NPG, 4.0)
        pet = parallel.partition_pet(lap0, 1)
        Md = torch.from_numpy((1.0 / lap0.diagonal()).astype(np.float32))
        rng = np.random.default_rng(SEED + 130)
        b_s = torch.from_numpy(rng.standard_normal(NPG * NPG).astype(np.float32)).to(dev)
        pm.reset_counts()
        n, summary = route_cell(
            f"sharded cg M_diag=Jacobi, one rank, unshifted 1M-row CSR, {DIST_JAC_STEPS} steps",
            lambda: parallel.sharded_solve(kt.cg, pet, b_s, mesh=mesh, M_diag=Md, tol=0.0,
                                           atol=0.0, maxiter=DIST_JAC_STEPS),
            (b_s,), card, (cs, sv, bs), forced=(3, 4, 8), repeats=DIST_REPEATS, phase="11a")
        captured = sum(c >= 1 for c in summary["rule"]["captures"])
        log(f"  11a the sharded cell's collectives over all its solves: {dict(pm.COUNTS)}; the "
            f"rule captured in {captured} of {DIST_REPEATS} timed solves")
        assert not any(pm.COUNTS.values()), pm.COUNTS
        # a held step's device time varies with the host's pace, so a
        # decision may go either way now and then: most solves capture
        assert 2 * captured > DIST_REPEATS, summary["rule"]
        assert n.get("csr_matvec", 0) >= DIST_JAC_STEPS, n
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    finally:
        dist.destroy_process_group()
    return launches


def single_solve(solver, A, b, dev, **kw):
    """``solver`` on one device (``while_loop``), a grid-shaped ``b`` with
    the full-contraction inner; its ``Info``."""
    b = torch.as_tensor(b).to(dev)
    if b.ndim >= 2 and hasattr(A, "grid") and tuple(b.shape[:2]) == tuple(A.grid):
        kw["inner"] = lambda u, v: torch.sum(u * v, dim=(0, 1))
    return solver(A, b, backend="while_loop", **kw)[1]


def sharded_cases(dev, kt, sv, st, ranks):
    """The sharded solves of 11b (and of ``tools/torch_multigpu_check.py``):
    ``(label, kernel, (solver, A, b), sharded_solve keywords, the same
    solve on one device)``, operators on the CPU for the ranks to split,
    their single-device twins on ``dev``; and ``(A, A on dev, right-hand
    sides, keywords)`` for ``make_sharded_solver``."""
    import functools

    from krylov_tpu_torch.ops import bsr as tb
    from krylov_tpu_torch.parallel import partition_pet

    rng = np.random.default_rng(SEED + 90)
    f32 = np.float32

    def single(solver, A, b, **kw):
        return single_solve(solver, A, b, dev, **kw)

    n = GLOO_N
    field = smooth_field(n).astype(f32)
    A_div = st.diffusion_2d(field, device="cpu")
    A_div_d = st.diffusion_2d(field, device=dev)
    Md = (1.0 / A_div.diagonal()).numpy()
    A_con = st.poisson_2d_const(n, dtype=np.float32, device=dev)
    interval = kt.utils.estimate_spectrum(A_con, iters=30)
    halo_sp, gather_sp = grid_csr(GLOO_NPG), scrambled_poisson(GLOO_NPG // 2)
    conv_sp, pois_sp = convected_csr(GLOO_NPG), poisson_csr(GLOO_NPG)
    blk_sp = block_spd_csr()
    A_bsr = tb.BSROperator.from_scipy(blk_sp, blocksize=(32, 32), device="cpu")
    A_small = st.poisson_2d(GLOO_NPG, dtype=np.float32, device="cpu")
    A_small_d = st.poisson_2d(GLOO_NPG, dtype=np.float32, device=dev)
    fixed = dict(tol=0.0, atol=0.0, maxiter=GLOO_STEPS)
    ones = np.ones((n, n), f32)
    b_sp = np.ones(GLOO_NPG * GLOO_NPG, f32)
    cheb = functools.partial(kt.ChebyshevPreconditioner, interval=interval, degree=6)
    pet_b = rng.standard_normal((b_sp.size, 8)).astype(f32)
    cases = [
        ("grid K1 diffusion_2d + M_diag, monitored", "stencil2d_matvec",
         (kt.cg, A_div, ones), dict(M_diag=Md, record=True, **fixed),
         lambda: single(kt.cg, A_div_d, ones,
                        M=kt.DiagonalOperator(torch.as_tensor(Md).reshape(n, n).to(dev)),
                        **fixed)),
        ("const K2 poisson_2d_const", "const_stencil2d_matvec",
         (kt.cg, st.poisson_2d_const(n, dtype=np.float32, device="cpu"), ones), dict(fixed),
         lambda: single(kt.cg, A_con, ones, **fixed)),
        ("const K2 + ChebyshevPreconditioner through M_factory", "const_stencil2d_matvec",
         (kt.cg, st.poisson_2d_const(n, dtype=np.float32, device="cpu"), ones),
         dict(M_factory=cheb, tol=0.0, atol=0.0, maxiter=20),
         lambda: single(kt.cg, A_con, ones, M=cheb(A_con), tol=0.0, atol=0.0, maxiter=20)),
        ("CSR halo mode", None, (kt.cg, halo_sp, b_sp), dict(fixed),
         lambda: single(kt.cg, kt.ops.sparse.CSROperator.from_scipy(halo_sp, device=dev), b_sp,
                        **fixed)),
        ("CSR gather mode", None, (kt.cg, gather_sp, b_sp[: gather_sp.shape[0]]), dict(fixed),
         lambda: single(kt.cg, kt.ops.sparse.CSROperator.from_scipy(gather_sp, device=dev),
                        b_sp[: gather_sp.shape[0]], **fixed)),
        ("PET qmr (K10 and its adjoint)", "csr_matvec",
         (kt.qmr, partition_pet(conv_sp, ranks), b_sp), dict(fixed),
         lambda: single(kt.qmr, sv.PETOperator.from_scipy(conv_sp, device=dev), b_sp, **fixed)),
        ("PET cg, b of (N, 8) (K11)", "csr_matmat",
         (kt.cg, partition_pet(pois_sp, ranks), pet_b), dict(fixed),
         lambda: single(kt.cg, sv.PETOperator.from_scipy(pois_sp, device=dev), pet_b, **fixed)),
        ("BSR cg (K12, 6c's block matrix)", "bsr_spmm",
         (kt.cg, A_bsr, np.ones(blk_sp.shape[0], f32)), dict(fixed),
         lambda: single(kt.cg, tb.BSROperator.from_scipy(blk_sp, blocksize=(32, 32), device=dev),
                        np.ones(blk_sp.shape[0], f32), **fixed)),
        ("gmres(restart=20), grid K1", "stencil2d_matvec",
         (kt.gmres, A_small, np.ones(A_small.grid, f32)), dict(restart=20, **fixed),
         lambda: single(kt.gmres, A_small_d, np.ones(A_small.grid, f32), restart=20, **fixed)),
    ]
    bs = [np.random.default_rng(SEED + 91 + j).standard_normal(A_small.grid).astype(f32)
          for j in range(3)]
    return cases, (A_small, A_small_d, bs, fixed)


def run_gloo_cases(pool, cases, dev, launches):
    """Each case on the pool's ranks, held to its single-device twin; every
    rank staged its transfers and launched the case's kernel (on the card);
    the ranks' launches added to ``launches``."""
    from krylov_tpu_torch.parallel import _spawn

    for label, kernel, args, kw, ref_fn in cases:
        t0 = time.perf_counter()
        res = pool.run(_spawn.solve_job, *args, **kw)
        wall = time.perf_counter() - t0
        ref = ref_fn()
        sharded_held(f"{label} ({wall * 1e3:.0f} ms on the ranks)", res["info"][1:], ref,
                     res["x"], ref.xk.cpu().numpy())
        per = res["per_rank"]
        log(f"    per rank launches {[p['launches'] for p in per]}; staged "
            f"{[sum(p['staged'].values()) for p in per]} transfers; collectives (rank 0) "
            f"{per_step(per[0]['collectives'], res['info'][1])} a step; routes (rank 0) "
            f"{per[0]['routes']}")
        if dev.type == "cuda":
            assert all(sum(p["staged"].values()) > 0 for p in per)
            # staged transfers: every rank's solve runs the host-stepped loop
            assert all(p["routes"]["graph_route"] == 0 < p["routes"]["host_stepped"]
                       for p in per), [p["routes"] for p in per]
            if kernel is not None:
                assert all(p["launches"].get(kernel, 0) > 0 for p in per), label
        assert not any(p["forbidden"] for p in per)
        if kw.get("record"):
            counts = [len(p["calls"]) for p in per]
            log(f"    ShardMonitor calls per rank {counts} (numsteps + 1 = "
                f"{res['info'][1] + 1})")
            assert counts == [res["info"][1] + 1] + [0] * (len(per) - 1)
        for p in per:
            for k, v in p["launches"].items():
                launches[k] = launches.get(k, 0) + v


def phase_distributed_gloo(dev, kt, sv, st, card):
    """11b: four ranks on this one card under gloo, every sharded operator."""
    from krylov_tpu_torch.parallel import _spawn

    log(f"phase 11b: {GLOO_RANKS} gloo ranks sharing this one card (NCCL takes one rank a "
        "GPU): every transfer staged through the host; a check of the sharded paths "
        f"against single-device solves on the card, not a timing [{card}]")
    cases, (A_small, A_small_d, bs, fixed) = sharded_cases(dev, kt, sv, st, GLOO_RANKS)
    launches = {}
    with _spawn.SPMDPool(GLOO_RANKS, backend="gloo", device=dev.type, timeout=600.0) as pool:
        run_gloo_cases(pool, cases, dev, launches)
        res = pool.run(_spawn.solver_job, kt.cg, A_small, bs, **fixed)
        for j, b in enumerate(bs):
            sharded_held(f"make_sharded_solver, right-hand side {j}", res["info"][j][1:],
                         single_solve(kt.cg, A_small_d, b, dev, **fixed))
        for p in res["per_rank"]:
            for k, v in p["launches"].items():
                launches[k] = launches.get(k, 0) + v
    log(f"  11b launches, all ranks: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the distributed preconditioners (M_partition, multigrid_factory)
# ---------------------------------------------------------------------------

PART_NPG = 256  # 12a's block-Jacobi and ILU-Schwarz matrices: 65,536 rows
GAL_MAXITER = 400  # 12a's Galerkin cycle: piecewise-constant transfer, no iteration bound


class LocalTwin:
    """``multigrid_factory(coupling="local")`` over ``ranks`` slabs, on one
    device: the single-device V-cycle on each slab of grid rows, with the
    slab edges as Dirichlet walls."""

    hermitian = True

    def __init__(self, kt, A, ranks):
        self.m = A.grid[0] // ranks
        local = type(A)((self.m, A.ny), A.offsets_nd, A.weights, A.dtype, device=A.device)
        self.M = kt.MultigridPreconditioner(local)
        self.ranks = ranks

    def __matmul__(self, r):
        return torch.cat([self.M @ r[i * self.m : (i + 1) * self.m] for i in range(self.ranks)])


def counted(cs, sv, pm, fn):
    """``fn()`` with every kernel, collective and route count set to 0 just
    before and read just after: ``(result, launches, collectives, route)``,
    the route a line of the driver's counts and last plan."""
    from krylov_tpu_torch import _driver

    cs.reset_launches()
    sv.reset_launches()
    pm.reset_counts()
    _driver.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**cs.LAUNCHES, **sv.LAUNCHES}.items() if v}
    c, last = _driver.COUNTS, _driver.LAST_GRAPH
    route = (f"graph route {c['graph_route']}, host-stepped {c['host_stepped']}, captures "
             f"{c['captures']}, steps replayed {c['graph_steps']}, uncapturable "
             f"{c['uncapturable']}" + (f" ({last.get('uncapturable')})"
                                       if c["uncapturable"] else ""))
    return out, launches, dict(pm.COUNTS), route


def per_step(coll, steps):
    return {k: round(v / max(steps, 1), 2) for k, v in coll.items() if v}


def phase_partitions_one(dev, kt, cs, sv, st, card):
    """12a: the distributed preconditioners through ``sharded_solve`` on one
    NCCL rank, at full width."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel
    from krylov_tpu_torch.parallel import mesh as pm
    from krylov_tpu_torch.parallel.solve import _general_operator

    log(f"phase 12a: distributed preconditioners on a world of one rank (NCCL) [{card}]")
    mesh = parallel.make_mesh(device=dev)
    launches = dict.fromkeys(list(cs.LAUNCHES) + list(sv.LAUNCHES), 0)

    def run(label, fn, M_l, r, setup):
        """The solve twice (a warm-up, then counted and timed); one
        application of the rank's preconditioner counted; the line."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (_, info), n, coll, route = counted(cs, sv, pm, fn)
        wall = time.perf_counter() - t0
        _, per_app, _, _ = counted(cs, sv, pm, lambda: M_l @ r)
        for k, v in n.items():
            launches[k] += v
        log(f"  [{card}] {label}: {wall * 1e3:.1f} ms, {info.numsteps} iterations "
            f"(success {info.success}), launches {n}, per application {per_app}, collectives "
            f"per step {per_step(coll, info.numsteps)}, host set-up {setup:.3f} s")
        log(f"    the rank's while_loop: {route}")
        assert not any(coll.values()), coll  # a rank alone launches no collective
        return info, n

    try:
        # the reference bench's cg_mg cell through the fully coupled cycle
        A = st.poisson_2d_const(BIG, device=dev)
        xs, b = manufactured(A, dev, SEED + 120)
        t0 = time.perf_counter()
        M_l = kt.multigrid_factory()(parallel.ShardedConstStencilOperator(A, BIG, mesh))
        setup = time.perf_counter() - t0
        assert isinstance(M_l, kt.ShardedMultigridPreconditioner)

        def mg():
            return parallel.sharded_solve(kt.cg, A, b, mesh=mesh, M_factory=kt.multigrid_factory(),
                                          tol=1e-6, maxiter=30)

        info, n = run(f"cg + multigrid_factory() on poisson_2d_const({BIG}) ({M_l.n_levels} "
                      "levels)", mg, M_l, b, setup)
        _, single = mg_cg(kt, A, b)
        fwd = float(torch.linalg.norm(info.xk.reshape(A.grid) - xs) / torch.linalg.norm(xs))
        log(f"    single-device MultigridPreconditioner: {single.numsteps} iterations; forward "
            f"error of the sharded solve {fwd:.3e}")
        assert info.success and abs(info.numsteps - single.numsteps) <= 2
        assert n.get("const_stencil2d_matvec", 0) > 0 and n.get("jacobi_sweep_const", 0) > 0, n
        idle_line(card, "cg + multigrid_factory() (one rank)", mg)

        # the Galerkin cycle on the smooth variable-coefficient field
        Ag = st.diffusion_2d(smooth_field(BIG).astype(np.float32), device=dev)
        xs, b = manufactured(Ag, dev, SEED + 121)
        t0 = time.perf_counter()
        M_g = kt.multigrid_factory()(parallel.ShardedGridStencilOperator(
            Ag.coeffs2d, Ag.offsets, Ag.ny, mesh, hermitian=True))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0

        def gal():
            return parallel.sharded_solve(kt.cg, Ag, b, mesh=mesh, M_factory=kt.multigrid_factory(),
                                          tol=1e-6, maxiter=GAL_MAXITER)

        info, n = run(f"cg + multigrid_factory() on diffusion_2d({BIG}), a = 1 + 0.9 sin cos "
                      f"(ShardedGalerkinMultigrid, {M_g.n_levels} levels)", gal, M_g, b, setup)
        res = float(torch.linalg.norm(b - Ag @ info.xk.reshape(Ag.grid)) / torch.linalg.norm(b))
        log(f"    explicit relative residual {res:.3e} (bound 1e-3; no iteration bound: "
            "piecewise-constant transfer is mesh-dependent)")
        assert res < 1e-3 and n.get("stencil2d_matvec", 0) > 0, n
        del Ag, M_g, b, xs

        # the reference bench's cg_amg cell through partition_amg
        rng = np.random.default_rng(SEED + 122)
        lap0 = poisson_csr(NPG, 4.0)
        nrow = lap0.shape[0]
        b = torch.from_numpy(rng.standard_normal(nrow).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        part = parallel.partition_amg(lap0, 1, dtype=np.float32)
        setup = time.perf_counter() - t0
        pet = parallel.partition_pet(lap0, 1)
        t0 = time.perf_counter()
        solver = parallel.make_sharded_solver(kt.cg, pet, mesh=mesh, tol=1e-4, maxiter=60,
                                              M_partition=part)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        log(f"  partition_amg({NPG}^2, 1): host set-up {setup:.3f} s, levels "
            f"{list(part.level_sizes)}; make_sharded_solver (the rank's slabs on the card) "
            f"{build:.3f} s")
        A_op = _general_operator(pet, mesh, nrow)[0]
        M_a = part.make_local(A_op, mesh)
        info, n = run(f"cg + partition_amg on the {NPG}^2 poisson (make_sharded_solver)",
                      lambda: solver(b), M_a, b, setup)
        _, again = solver(b)
        same = np.array_equal(info.resnorms, again.resnorms) and torch.equal(info.xk, again.xk)
        res = host_residual(lap0, b, info.xk)
        log(f"    repeat bitwise equal {same}; float64 host residual {res:.3e}")
        assert info.success and same and res <= HOST_RTOL
        assert n.get("csr_matvec", 0) > 0, n
        Ap = sv.PETOperator.from_scipy(part.padded_matrix(0), with_rmatvec=False, device=dev)
        _, twin = kt.cg(Ap, b, M=part.as_global(dev), tol=1e-4, maxiter=60, backend="while_loop")
        m = min(len(info.resnorms), len(twin.resnorms)) - 1
        rel = float(np.max(np.abs(info.resnorms[:m] - twin.resnorms[:m]) / twin.resnorms[:m]))
        M1 = kt.AMGPreconditioner.from_scipy(lap0, dtype=np.float32, fine_operator=Ap, device=dev)
        _, one = kt.cg(Ap, b, M=M1, tol=1e-4, maxiter=60, backend="while_loop")
        log(f"    as_global() twin: {twin.numsteps} iterations, max rel resnorm {rel:.3e} (rtol "
            f"{TRAJ_RTOL}); single-device AMGPreconditioner: {one.numsteps} iterations, levels "
            f"{list(M1.level_sizes)}")
        assert abs(info.numsteps - twin.numsteps) <= 1 and rel <= TRAJ_RTOL and one.success
        idle_line(card, "cg + partition_amg (one rank)", lambda: solver(b))
        del solver, M_a, A_op, Ap, M1, pet, part

        # block Jacobi and ILU(0)-Schwarz at 65,536 rows (true grids)
        g = PART_NPG
        b = torch.from_numpy(rng.standard_normal(g * g).astype(np.float32)).to(dev)
        for label, sp, solver_fn, key, build_part, tol, maxiter in (
            ("cg + partition_block_jacobi(block=64)", grid_csr(g), kt.cg, "M",
             lambda sp: parallel.partition_block_jacobi(sp, 1, block=64), BJ_TOL, 2000),
            ("bicgstab + partition_ilu0, convected", grid_csr(g, 0.5, 0.4), kt.bicgstab, "Ml",
             lambda sp: parallel.partition_ilu0(sp, 1), 1e-4, 200),
        ):
            t0 = time.perf_counter()
            prt = build_part(sp)
            setup = time.perf_counter() - t0
            pet = parallel.partition_pet(sp, 1)
            M_p = prt.make_local(_general_operator(pet, mesh, g * g)[0], mesh)

            def solve(pet=pet, prt=prt, solver_fn=solver_fn, tol=tol, maxiter=maxiter):
                return parallel.sharded_solve(solver_fn, pet, b, mesh=mesh, tol=tol,
                                              maxiter=maxiter, M_partition=prt)

            info, n = run(f"{label} at {g}^2", solve, M_p, b, setup)
            op = sv.PETOperator.from_scipy(sp, device=dev)
            _, twin = solver_fn(op, b, tol=tol, maxiter=maxiter, backend="while_loop",
                                **{key: prt.as_global(dev)})
            m = min(len(info.resnorms), len(twin.resnorms)) - 1
            rel = float(np.max(np.abs(info.resnorms[:m] - twin.resnorms[:m]) / twin.resnorms[:m]))
            res = host_residual(sp, b, info.xk)
            log(f"    as_global() twin: {twin.numsteps} iterations, max rel resnorm {rel:.3e}; "
                f"float64 host residual {res:.3e}")
            assert info.success and abs(info.numsteps - twin.numsteps) <= 1 and rel <= TRAJ_RTOL
            assert n.get("csr_matvec", 0) > 0, n
    finally:
        dist.destroy_process_group()
    return launches


def partition_cases(dev, kt, sv, st, ranks):
    """The sharded solves of 12b (and of ``tools/torch_multigpu_check.py``):
    ``(label, kernel, (solver, A, b), sharded_solve keywords, the same solve
    on one device)`` as :func:`sharded_cases`; each single-device twin runs
    the same preconditioner: the sharded cycles on ``Mesh.of_one`` (their
    hierarchies do not depend on the rank count here), the slab-local cycle
    as :class:`LocalTwin`, the partitions' ``as_global()``."""
    from krylov_tpu_torch import parallel

    f32 = np.float32
    n = GLOO_N
    one = parallel.mesh.Mesh.of_one(dev)
    ones = np.ones((n, n), f32)
    A_con_h = st.poisson_2d_const(n, dtype=np.float32, device="cpu")
    A_con = st.poisson_2d_const(n, dtype=np.float32, device=dev)
    field = smooth_field(n).astype(f32)
    A_div_h, A_div = st.diffusion_2d(field, device="cpu"), st.diffusion_2d(field, device=dev)
    lap0, conv, spd = poisson_csr(GLOO_NPG, 4.0), grid_csr(GLOO_NPG, 0.5, 0.4), grid_csr(GLOO_NPG)
    b_sp = np.random.default_rng(SEED + 123).standard_normal(lap0.shape[0]).astype(f32)
    amg = parallel.partition_amg(lap0, ranks, dtype=f32, n_sharded_levels=2, smoother="chebyshev")
    ilu = parallel.partition_ilu0(conv, ranks, with_rmatvec=True)
    bj = parallel.partition_block_jacobi(spd, ranks, block=64)

    def fixed(k):
        return dict(tol=0.0, atol=0.0, maxiter=k)

    def mg_twin(coupling):
        if coupling == "local":
            return LocalTwin(kt, A_con, ranks)
        return kt.multigrid_factory(coupling=coupling)(
            parallel.ShardedConstStencilOperator(A_con, n, one))

    cases = [
        (f"cg + multigrid_factory(coupling={c!r})", "const_stencil2d_matvec",
         (kt.cg, A_con_h, ones), dict(M_factory=kt.multigrid_factory(coupling=c), **fixed(12)),
         lambda c=c: single_solve(kt.cg, A_con, ones, dev, M=mg_twin(c), **fixed(12)))
        for c in ("auto", "full", "local")
    ]
    cases += [
        ("cg + multigrid_factory(), Galerkin", "stencil2d_matvec", (kt.cg, A_div_h, ones),
         dict(M_factory=kt.multigrid_factory(), **fixed(30)),
         lambda: single_solve(kt.cg, A_div, ones, dev, M=kt.multigrid_factory()(
             parallel.ShardedGridStencilOperator(A_div.coeffs2d, A_div.offsets, A_div.ny, one,
                                                 hermitian=True)), **fixed(30))),
        ("cg + partition_amg(n_sharded_levels=2, chebyshev)", "csr_matvec",
         (kt.cg, parallel.partition_pet(lap0, ranks), b_sp), dict(M_partition=amg, **fixed(15)),
         lambda: single_solve(kt.cg, sv.PETOperator.from_scipy(lap0, device=dev), b_sp, dev,
                              M=amg.as_global(dev), **fixed(15))),
        ("qmr + partition_ilu0(with_rmatvec=True), convected", "csr_matvec",
         (kt.qmr, parallel.partition_pet(conv, ranks), b_sp), dict(M_partition=ilu, **fixed(10)),
         lambda: single_solve(kt.qmr, sv.PETOperator.from_scipy(conv, device=dev), b_sp, dev,
                              Ml=ilu.as_global(dev), **fixed(10))),
        ("cg + partition_block_jacobi(block=64)", "csr_matvec",
         (kt.cg, parallel.partition_pet(spd, ranks), b_sp), dict(M_partition=bj, **fixed(50)),
         lambda: single_solve(kt.cg, sv.PETOperator.from_scipy(spd, device=dev), b_sp, dev,
                              M=bj.as_global(dev), **fixed(50))),
    ]
    return cases


def phase_partitions_gloo(dev, kt, sv, st, card):
    """12b: four ranks on this one card under gloo, every new path."""
    from krylov_tpu_torch.parallel import _spawn

    log(f"phase 12b: {GLOO_RANKS} gloo ranks sharing this one card: the distributed "
        "preconditioners against their single-device twins (a check, not a timing) "
        f"[{card}]")
    launches = {}
    with _spawn.SPMDPool(GLOO_RANKS, backend="gloo", device=dev.type, timeout=600.0) as pool:
        run_gloo_cases(pool, partition_cases(dev, kt, sv, st, GLOO_RANKS), dev, launches)
    log(f"  12b launches, all ranks: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the device-resident loop (the while_loop graph route)
# ---------------------------------------------------------------------------

ROUTE_REPEATS = 10  # timed solves of each route a cell, alternating
COUNTED_REPEATS = 5  # the same for the cells of the methods whose step depends on its number


def device_busy(fn):
    """(device-busy s, kernel events) of one call of ``fn`` by
    ``torch.profiler``'s CUDA events; kernels replayed from a CUDA graph
    are recorded like launched ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) * 1e-6, sum(e.count for e in rows)


def all_launches(cs, sv, bs):
    """Every kernel wrapper's launch counts, K2's and K12's paths too."""
    return {**cs.LAUNCHES, **{f"K2 {k}": v for k, v in cs.K2_PATHS.items()}, **sv.LAUNCHES,
            **bs.LAUNCHES, **{f"K12 {k}": v for k, v in bs.K12_PATHS.items()}}


def route_counted(solve, mods, ctx):
    """``(info, launches, the driver's counts, LAST_GRAPH)`` of one
    ``solve()`` under ``ctx``."""
    from krylov_tpu_torch import _driver

    for mod in mods:
        mod.reset_launches()
    _driver.reset_counts()
    with ctx:
        _, info = solve()
    torch.cuda.synchronize()
    return info, all_launches(*mods), dict(_driver.COUNTS), dict(_driver.LAST_GRAPH)


def route_cell(name, solve, inputs, card, mods, forced=None, repeats=None, phase="13"):
    """One cell of phase 13: ``solve()`` (a ``while_loop`` solve, returning
    ``(x, info)``) on the route the driver's cost rule picks, on the
    host-stepped loop and, with ``forced`` (``(after, steps, replays)``),
    under a capture forced by ``_driver._capture_at``.  Holds each route's
    history, step count, success, iterate and kernel launches bit for bit
    to the host-stepped loop's, ``inputs`` (the caller's tensors)
    unchanged, and the memory back at its level (the reserved memory after
    ``torch.cuda.empty_cache()``); the forced route to a capture and the
    stop flag read less than once a step.  Times the routes alternating,
    ``repeats`` each (``ROUTE_REPEATS`` for None), and holds the rule's
    median to the host-stepped median plus the larger spread.  With ``forced``, measures the kept
    pool: the reserved memory with it and without it
    (``_graphs.release_pools``).  ``phase`` heads its lines.  Returns the
    counted solve's kernel launches and a summary."""
    import gc

    from krylov_tpu_torch import _driver, _graphs

    repeats = ROUTE_REPEATS if repeats is None else repeats
    t_cell = time.perf_counter()
    before = [t.clone() for t in inputs]
    torch.cuda.synchronize()
    base0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref, n_host, _, _ = route_counted(solve, mods, _driver._host_stepped())
    host_peak_mb = (torch.cuda.max_memory_allocated() - base0) / 2**20
    routes = {"rule": contextlib.nullcontext}
    if forced:
        routes["forced"] = lambda: _driver._capture_at(*forced)
    got = {}
    for route, ctx in routes.items():
        info, launches, counts, last = route_counted(solve, mods, ctx())
        same = (info.numsteps == ref.numsteps and info.success == ref.success
                and np.array_equal(info.resnorms, ref.resnorms) and torch.equal(info.xk, ref.xk))
        unchanged = all(torch.equal(t, t0) for t, t0 in zip(inputs, before))
        log(f"  {phase} {name}, {route}: {info.numsteps} steps, success {info.success}; {counts}; "
            f"plan {last.get('plan')} after {last.get('host_steps')} host steps; bit-equal to "
            f"the host-stepped loop {same}; inputs unchanged {unchanged}; launches "
            f"{ {k: v for k, v in launches.items() if v} } (host-stepped the same: "
            f"{launches == n_host})")
        for k, costs, plan in last.get("decisions", ()):
            log(f"  [{card}] {phase} {name} the rule after host step {k}: plan {plan}, "
                + ", ".join(f"{f} {v:.4g}" for f, v in costs._asdict().items()))
        assert counts["graph_route"] == 1 and counts["host_stepped"] == 0, counts
        assert same and unchanged and launches == n_host, (name, route, launches, n_host)
        if route == "forced":
            assert counts["captures"] == 1, (name, counts)
            assert counts["flag_reads"] < info.numsteps, (name, counts)
        got[route] = launches
        del info
    steps = ref.numsteps
    del ref
    walls = {"host-stepped": [], **{r: [] for r in routes}}
    parts = {r: [] for r in routes}
    ctxs = {"host-stepped": _driver._host_stepped, **routes}
    for rep in range(repeats):
        for route in list(walls)[::1 if rep % 2 == 0 else -1]:  # parent, change, change, parent
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            _driver.reset_counts()
            t0 = time.perf_counter()
            with ctxs[route]():
                out = solve()
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
            del out
            if route != "host-stepped":
                parts[route].append((dict(_driver.LAST_GRAPH), dict(_driver.COUNTS)))
                torch.cuda.synchronize()
                left = torch.cuda.memory_allocated() - base
                assert left == 0, f"{name}, {route}: {left} bytes left after a solve"
        p = parts["rule"][-1][0]
        log(f"    {phase} {name} repeat {rep}: host-stepped {walls['host-stepped'][-1] * 1e3:.3f} ms, "
            + ", ".join(f"{r} {walls[r][-1] * 1e3:.3f} ms" for r in routes)
            + f"; the rule: plan {p['plan']} after {p['host_steps']} host steps "
            f"({p['host_steps_s'] * 1e3:.3f} ms), {p['held_steps']} held, decisions "
            f"{p['decide_s'] * 1e3:.3f} ms, capture {p['capture_s'] * 1e3:.3f} + "
            f"{p['instantiate_s'] * 1e3:.3f} ms, replays {p['replays_s'] * 1e3:.3f} ms"
            + ("" if p["plan"] is not None or not p["decisions"] else
               "; its last decision, after host step {}: {}".format(
                   p["decisions"][-1][0], ", ".join(
                       f"{f} {v:.4g}" for f, v in p["decisions"][-1][1]._asdict().items()))))
    for ctx in routes.values():
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        with ctx():
            solve()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_reserved() - reserved
        assert left == 0, f"{name}: {left} bytes still reserved after a solve"
    pool_mb = None
    if forced:
        # the kept pool: what the device holds with it and without it
        torch.cuda.empty_cache()
        with_pool = torch.cuda.memory_reserved()
        assert _graphs.release_pools(), name
        gc.collect()
        torch.cuda.empty_cache()
        pool_mb = (with_pool - torch.cuda.memory_reserved()) / 2**20
    med = {r: float(np.median(w)) for r, w in walls.items()}
    spread = {r: float(np.max(w) - np.min(w)) for r, w in walls.items()}
    diffs = [g - h for g, h in zip(walls["rule"], walls["host-stepped"])]
    busy = {}
    for route, ctx in ctxs.items():
        with ctx():
            busy[route] = device_busy(solve)
    summary = dict(name=name, steps=steps, host_peak_mb=host_peak_mb, pool_mb=pool_mb)
    for route in walls:
        summary[route] = dict(
            ms=med[route] * 1e3, spread_ms=spread[route] * 1e3, busy_ms=busy[route][0] * 1e3,
            idle=1 - busy[route][0] / med[route])
        log(f"  [{card}] {phase} {name} {route}: {med[route] * 1e3:.3f} ms (spread "
            f"{spread[route] * 1e3:.3f}), median of {repeats}, alternating; a step "
            f"{med[route] / steps * 1e6:.1f} us; device busy {busy[route][0] * 1e3:.3f} ms "
            f"({busy[route][1]} kernel events), idle share {summary[route]['idle']:.3f}")
        if route in parts:
            cap_ms = [(p["capture_s"] + p["instantiate_s"]) * 1e3 for p, _ in parts[route]]
            summary[route].update(
                captures=[c["captures"] for _, c in parts[route]],
                host_steps=[p["host_steps"] for p, _ in parts[route]],
                capture_ms=[round(c, 3) for c in cap_ms],
                flag_reads_a_step=float(np.median([c["flag_reads"] for _, c in parts[route]]))
                / steps)
            log(f"  [{card}] {phase} {name} {route}: captures {summary[route]['captures']}, host "
                f"steps before the capture {summary[route]['host_steps']}, capture and "
                f"instantiation ms {summary[route]['capture_ms']}, flag reads a step "
                f"{summary[route]['flag_reads_a_step']:.3f}")
    summary["rule_minus_host_ms"] = float(np.median(diffs)) * 1e3
    summary["cell_s"] = time.perf_counter() - t_cell
    log(f"  [{card}] {phase} {name}: the rule's route minus the host-stepped loop, pair by pair: "
        f"median {np.median(diffs) * 1e3:+.3f} ms, {sum(d <= 0 for d in diffs)} of "
        f"{len(diffs)} pairs no slower; the host-stepped solve's peak {host_peak_mb:.0f} MB "
        f"over its inputs" + ("" if pool_mb is None else f"; the kept pool {pool_mb:.0f} MB")
        + f"; the cell took {summary['cell_s']:.1f} s")
    assert med["rule"] <= med["host-stepped"] + max(spread["rule"], spread["host-stepped"]), (
        name, med, spread)
    return got["rule"], summary


def counted_solves(dev, kt, st):
    """The solves of 13's cells of the methods whose step depends on its
    step number (``Method.counted``: picks on the device counter, IF nodes,
    WHILE-node sweeps), as ``(name, solve, inputs)``: ``gmres`` x3 on the
    bench's convected 1M-row CSR (its 6b call), ``tfqmr``, ``cg_pipelined``,
    ``cg_block`` ``(N, 8)`` (K11), ``symmlq`` (100 fixed steps: its reported
    norm vanishes only once the Krylov space is exhausted) and ``gcr`` on
    the shifted Poisson CSR (7c's matrix), ``chebyshev`` on
    ``poisson_2d_const(1024)`` (K2) with the Laplacian's analytic spectrum
    (1000 fixed steps: it takes ~2400 to 1e-3 in float32, and at 1e-4 its
    recurrence residual parts from the explicit one, and each of ~900
    failed rechecks reads the host)."""
    conv, lap = convected_csr(NPG), poisson_csr(NPG)
    op_c, op = kt.as_operator(conv, dev), kt.as_operator(lap, dev)
    assert type(op_c).__name__ == type(op).__name__ == "PETOperator"
    rng = np.random.default_rng(SEED + 131)
    b = torch.from_numpy(rng.standard_normal(NPG * NPG).astype(np.float32)).to(dev)
    B = torch.from_numpy(rng.standard_normal((NPG * NPG, 8)).astype(np.float32)).to(dev)
    jac = kt.DiagonalOperator(torch.from_numpy(1.0 / lap.diagonal()).to(dev))
    A = st.poisson_2d_const(NPG, device=dev)
    bg = b.reshape(A.grid)
    c = 4.0 * np.cos(np.pi / (NPG + 1))  # the spectrum: 4 -+ 4 cos(pi / (n + 1))
    wl = dict(backend="while_loop")
    cells = [(f"gmres {o}, convected 1M-row CSR, to 1e-4", lambda o=o: kt.gmres(
        op_c, b, ortho=o, tol=1e-4, maxiter=120, **wl), (b,))
        for o in ("mgs", "householder", "cgs")]
    return cells + [
        ("tfqmr M=Jacobi, 1M-row CSR, to 1e-4", lambda: kt.tfqmr(
            op, b, M=jac, tol=1e-4, maxiter=400, **wl), (b,)),
        ("cg_pipelined M=Jacobi, 1M-row CSR, to 1e-4", lambda: kt.cg_pipelined(
            op, b, M=jac, tol=1e-4, maxiter=400, **wl), (b,)),
        ("cg_block (N, 8) (K11), 1M-row CSR, to 1e-4", lambda: kt.cg_block(
            op, B, tol=1e-4, maxiter=400, **wl), (B,)),
        ("symmlq, 1M-row CSR, 100 steps", lambda: kt.symmlq(
            op, b, tol=0.0, atol=0.0, maxiter=100, **wl), (b,)),
        ("gcr, 1M-row CSR, to 1e-4", lambda: kt.gcr(op, b, tol=1e-4, maxiter=120, **wl), (b,)),
        ("chebyshev, poisson_2d_const(1024) (K2), 1000 steps", lambda: kt.chebyshev(
            A, bg, (4.0 - c, 4.0 + c), inner=inner, tol=0.0, atol=0.0, maxiter=1000, **wl),
         (bg,)),
    ]


def phase_graph_loop(dev, kt, cs, sv, bs, st, card):
    """13: the ``while_loop`` route the cost rule picks against the
    host-stepped loop at full width, each cell through :func:`route_cell`:
    generic and the three fused CGs at 4096^2, MG-CG on
    ``poisson_2d_const(4096)``, ``bicgstab``, ``qmr`` and ``cg`` + Jacobi on
    the bench's 1M-row CSR, ``cg`` + AMG on its unshifted matrix, ``cg``
    with an ``(N, 8)`` b (K11) and on the block-structured SPD matrix
    (K12), then :func:`counted_solves`'s cells.  Returns the rule's solves' kernel
    launches."""
    log(f"phase 13: the device-resident loop (captured CUDA graphs) against the host-stepped "
        f"loop, at {BIG}^2 and {NPG * NPG} rows")
    log(f"  torch.cuda.CUDAGraph.begin_capture_to_if_node: "
        f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}; torch.version.cuda "
        f"{torch.version.cuda} (the IF nodes: krylov_tpu_torch/csrc/graph.cu)")
    t_phase = time.perf_counter()
    totals = {}
    summary = []
    mods = (cs, sv, bs)

    def cell(name, solve, *inputs, forced=None, repeats=None):
        n, row = route_cell(name, solve, inputs, card, mods, forced, repeats)
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v
        summary.append(row)

    fixed = dict(tol=0.0, atol=0.0, maxiter=100)
    A_p = st.poisson_2d(BIG, dtype=np.float32, device=dev)
    b = torch.ones(A_p.grid, dtype=torch.float32, device=dev)
    cell("cg, poisson_2d, 100 steps", lambda: kt.cg(A_p, b, inner=inner,
                                                     backend="while_loop", **fixed), b,
         forced=(3, 8, 4))
    cell("fused cg (K5/K4), poisson_2d, 100 steps",
         lambda: kt.cg_stencil(A_p, b, fused=True, **fixed), b, forced=(3, 4, 8))
    cell("fused Jacobi cg (K6/K7), poisson_2d, 100 steps",
         lambda: kt.cg_stencil(A_p, b, fused=True, M="jacobi", **fixed), b,
         forced=(3, 4, 8))
    del A_p
    A_c = st.poisson_2d_const(BIG, device=dev)
    cell("fused const cg (K3/K4), poisson_2d_const, 100 steps",
         lambda: kt.cg_stencil(A_c, b, fused=True, **fixed), b, forced=(3, 4, 8))
    M = kt.MultigridPreconditioner(A_c)
    _, b_mg = manufactured(A_c, dev, SEED + 20)
    cell("MG-CG, poisson_2d_const, to 1e-6", lambda: mg_cg(kt, A_c, b_mg, M), b_mg)
    del A_c, M, b_mg, b

    lap, lap0 = poisson_csr(NPG), poisson_csr(NPG, 4.0)
    op, op0 = kt.as_operator(lap, dev), kt.as_operator(lap0, dev)
    assert type(op).__name__ == type(op0).__name__ == "PETOperator"
    rng = np.random.default_rng(SEED + 130)
    b_s = torch.from_numpy(rng.standard_normal(NPG * NPG).astype(np.float32)).to(dev)

    def jac(sp):
        return kt.DiagonalOperator(torch.from_numpy(1.0 / sp.diagonal()).to(dev))

    cell("bicgstab Ml=Jacobi, 1M-row CSR, to 1e-4", lambda: kt.bicgstab(
        op, b_s, Ml=jac(lap), tol=1e-4, maxiter=400, backend="while_loop"), b_s)
    cell("qmr Ml=Jacobi, 1M-row CSR, to 1e-4", lambda: kt.qmr(
        op, b_s, Ml=jac(lap), tol=1e-4, maxiter=400, backend="while_loop"), b_s,
        forced=(3, 2, 8))
    cell("cg M=Jacobi, unshifted 1M-row CSR, 1500 steps", lambda: kt.cg(
        op0, b_s, M=jac(lap0), tol=1e-4, maxiter=1500, backend="while_loop"), b_s,
        forced=(3, 4, 8))
    amg = kt.AMGPreconditioner.from_scipy(lap0, dtype=np.float32, fine_operator=op0, device=dev)
    cell("cg + AMG, unshifted 1M-row CSR, to 1e-4", lambda: kt.cg(
        op0, b_s, M=amg, tol=1e-4, maxiter=60, backend="while_loop"), b_s)
    del amg
    B = torch.from_numpy(rng.standard_normal((NPG * NPG, 8)).astype(np.float32)).to(dev)
    cell("cg, (N, 8) b (K11), 1M-row CSR, to 1e-5", lambda: kt.cg(
        op, B, tol=1e-5, maxiter=300, backend="while_loop"), B)
    del op, op0, B, b_s
    spd = block_spd_csr()
    op_b = kt.as_operator(spd, dev)
    assert type(op_b).__name__ == "BSROperator"
    Bb = torch.from_numpy(rng.standard_normal((spd.shape[0], 8)).astype(np.float32)).to(dev)
    cell("cg, (N, 8) b, block-tridiagonal BSR (K12), to 1e-5", lambda: kt.cg(
        op_b, Bb, tol=1e-5, maxiter=300, backend="while_loop"), Bb)
    del op_b, Bb
    for name, solve, inputs in counted_solves(dev, kt, st):
        cell(name, solve, *inputs, forced=(3, 4, 8), repeats=COUNTED_REPEATS)
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    log("  13 summary: " + json.dumps(summary))
    return totals


KEPT_RUNS = 10  # right-hand sides through each of 14's built solvers, on each route


def kept_cell(name, build, rhs, card, mods):
    """One cell of phase 14: ``KEPT_RUNS`` right-hand sides through the
    solver ``build()`` returns (``parallel.make_sharded_solver``) on its
    graph route, which keeps the graph of its first capture and replays it
    in the later runs, alternating run by run with the same sequence on the
    host-stepped loop (``_driver._host_stepped()``).  ``rhs(j, prev)``
    gives run ``j``'s ``(b, x0)``, ``prev`` the route's last iterate.
    Holds every run bit for bit to the host-stepped one and the later runs'
    median to the host-stepped median plus the larger spread; prints the
    memory the solver leaves once it is gone.  Returns the kernel launches
    of both routes and a summary."""
    import gc

    from krylov_tpu_torch import _driver

    t_cell = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    run = build()
    ctxs = {"host-stepped": _driver._host_stepped, "kept": contextlib.nullcontext}
    walls = {r: [] for r in ctxs}
    prev = dict.fromkeys(ctxs)
    launches, first, same, counts = {}, None, [], dict.fromkeys(
        ("captures", "replays", "kept_runs", "host_steps", "graph_steps", "host_stepped"), 0)
    for j in range(KEPT_RUNS):
        got = {}
        for route in list(ctxs)[::1 if j % 2 == 0 else -1]:  # alternating
            b, x0 = rhs(j, prev[route])
            for mod in mods:
                mod.reset_launches()
            _driver.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctxs[route]():
                _, info = run(b, x0)
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
            for k, v in all_launches(*mods).items():
                launches[k] = launches.get(k, 0) + v
            got[route] = info
            prev[route] = info.xk
            if route == "kept":
                for k in counts:
                    counts[k] += _driver.COUNTS[k]
                if j == 0:
                    first = dict(_driver.LAST_GRAPH, wall_s=walls[route][-1])
        h, g = got["host-stepped"], got["kept"]
        same.append(h.numsteps == g.numsteps and h.success == g.success
                    and np.array_equal(h.resnorms, g.resnorms) and torch.equal(h.xk, g.xk))
        log(f"    14 {name} run {j}: {g.numsteps} steps, host-stepped "
            f"{walls['host-stepped'][-1] * 1e3:.3f} ms, kept {walls['kept'][-1] * 1e3:.3f} ms "
            f"({_driver.LAST_GRAPH.get('kept')}), bit-equal {same[-1]}")
        del got, h, g, info
    later = {r: walls[r][1:] for r in walls}
    med = {r: float(np.median(w)) for r, w in later.items()}
    spread = {r: float(np.max(w) - np.min(w)) for r, w in later.items()}
    b, x0 = rhs(KEPT_RUNS, prev["kept"])
    busy = {}
    for route, ctx in ctxs.items():
        with ctx():
            busy[route] = device_busy(lambda: run(b, x0))[0]
    del prev, b, x0, run
    gc.collect()
    torch.cuda.synchronize()
    left_mb = (torch.cuda.memory_allocated() - base) / 2**20
    row = dict(name=name, first_ms=first["wall_s"] * 1e3, kept_as=first.get("kept"),
               unkept=first.get("unkept"), plan=first.get("plan"),
               replay_step_us=None if first.get("replay_step_s") is None
               else first["replay_step_s"] * 1e6, counts=counts, bit_equal=all(same),
               left_mb=left_mb, **{f"first_{k}_ms": first.get(k, 0.0) * 1e3 for k in (
                   "host_steps_s", "decide_s", "capture_s", "instantiate_s", "replays_s")})
    for r in ctxs:
        row[r] = dict(ms=med[r] * 1e3, spread_ms=spread[r] * 1e3, busy_ms=busy[r] * 1e3,
                      idle=1 - busy[r] / med[r])
    log(f"  [{card}] 14 {name}: first run {row['first_ms']:.3f} ms ({row['kept_as']}; plan "
        f"{row['plan']} after {first.get('host_steps')} host steps, "
        + ", ".join(f"{k} {row[f'first_{k}_ms']:.3f}" for k in (
            "host_steps_s", "decide_s", "capture_s", "instantiate_s", "replays_s"))
        + f" ms; a replayed step {row['replay_step_us']} us" + (
            f"; not kept: {row['unkept']}" if row["unkept"] else "") + ")")
    for r in ctxs:
        log(f"  [{card}] 14 {name} {r}: runs 2-{KEPT_RUNS} median {row[r]['ms']:.3f} ms "
            f"(spread {row[r]['spread_ms']:.3f}); one profiled run: device busy "
            f"{row[r]['busy_ms']:.3f} ms, idle share {row[r]['idle']:.3f}")
    for d in first.get("decisions", ()):
        log(f"  [{card}] 14 {name} the rule after host step {d[0]}: plan {d[2]}, "
            + ", ".join(f"{f} {v:.4g}" for f, v in d[1]._asdict().items()))
    log(f"  [{card}] 14 {name}: the kept route's counts {counts}; every run bit-equal to the "
        f"host-stepped one {all(same)}; {left_mb:.1f} MB left once the solver is gone; the cell "
        f"took "
        f"{time.perf_counter() - t_cell:.1f} s")
    assert all(same), (name, same)
    assert med["kept"] <= med["host-stepped"] + max(spread.values()), (name, med, spread)
    if row["kept_as"] == "captured":
        assert counts["captures"] == 1 and counts["kept_runs"] == KEPT_RUNS - 1, (name, counts)
    return launches, row


def phase_kept(dev, kt, cs, sv, bs, st, card):
    """14: the reference's build-once solver: ``KEPT_RUNS`` right-hand sides
    through one ``make_sharded_solver`` on one NCCL rank at full width,
    the kept graph against the host-stepped loop (:func:`kept_cell`):
    MG-CG on ``poisson_2d_const(4096)`` (``multigrid_factory``, manufactured
    right-hand sides, ``x0`` the last solution), ``cg`` + ``partition_amg``
    on the unshifted 1024^2 CSR (12a's), ``bicgstab`` with a Jacobi
    ``M_diag`` on the 1M-row CSR, ``gmres`` (MGS) on the convected one, and
    generic ``cg`` on ``poisson_2d(4096)``, 100 fixed steps, whose captured
    step the rule should find no cheaper than the host's.  Returns the
    launches."""
    import torch.distributed as dist

    from krylov_tpu_torch import parallel

    log(f"phase 14: a solver built once keeps its captured graph across {KEPT_RUNS} right-hand "
        f"sides (make_sharded_solver on one NCCL rank) [{card}]")
    t_phase = time.perf_counter()
    mesh = parallel.make_mesh(device=dev)
    mods = (cs, sv, bs)
    totals, summary = {}, []
    rng = np.random.default_rng(SEED + 140)

    def cell(name, build, rhs):
        n, row = kept_cell(name, build, rhs, card, mods)
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v
        summary.append(row)

    def vec(n, *shape):
        return torch.from_numpy(rng.standard_normal((n,) + shape).astype(np.float32)).to(dev)

    try:
        A = st.poisson_2d_const(BIG, device=dev)
        rhs = [manufactured(A, dev, SEED + 141 + j)[1] for j in range(KEPT_RUNS + 1)]
        cell(f"MG-CG, poisson_2d_const({BIG}), multigrid_factory, to 1e-6, x0 the last solution",
             lambda: parallel.make_sharded_solver(
                 kt.cg, A, mesh=mesh, M_factory=kt.multigrid_factory(), tol=1e-6, maxiter=30),
             lambda j, prev: (rhs[j], prev))
        del A, rhs
        lap0 = poisson_csr(NPG, 4.0)
        bs_ = [vec(NPG * NPG) for _ in range(KEPT_RUNS + 1)]
        cell(f"cg + partition_amg, unshifted {NPG}^2 CSR, to 1e-4",
             lambda: parallel.make_sharded_solver(
                 kt.cg, parallel.partition_pet(lap0, 1), mesh=mesh, tol=1e-4, maxiter=60,
                 M_partition=parallel.partition_amg(lap0, 1, dtype=np.float32)),
             lambda j, prev: (bs_[j], None))
        lap = poisson_csr(NPG)
        cell(f"bicgstab M_diag=Jacobi, {NPG * NPG}-row CSR, to 1e-4",
             lambda: parallel.make_sharded_solver(
                 kt.bicgstab, parallel.partition_pet(lap, 1), mesh=mesh,
                 M_diag=(1.0 / lap.diagonal()).astype(np.float32), tol=1e-4, maxiter=400),
             lambda j, prev: (bs_[j], None))
        cell(f"gmres mgs, convected {NPG * NPG}-row CSR, to 1e-4",
             lambda: parallel.make_sharded_solver(
                 kt.gmres, parallel.partition_pet(convected_csr(NPG), 1), mesh=mesh, tol=1e-4,
                 maxiter=120),
             lambda j, prev: (bs_[j], None))
        del bs_, lap, lap0
        A_p = st.poisson_2d(BIG, dtype=np.float32, device=dev)
        grids = [vec(BIG, BIG) for _ in range(KEPT_RUNS + 1)]
        cell(f"cg, poisson_2d({BIG}), 100 fixed steps",
             lambda: parallel.make_sharded_solver(kt.cg, A_p, mesh=mesh, tol=0.0, atol=0.0,
                                                  maxiter=100),
             lambda j, prev: (grids[j], None))
        del A_p, grids
    finally:
        dist.destroy_process_group()
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    log("  14 summary: " + json.dumps(summary, default=str))
    return totals


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 0: {card}")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    path, seconds, build_log = _build.build()
    log(f"  kernels built in {seconds:.1f} s -> {path.name}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("   ", line.strip())

    errs, A_div = phase_kernels(dev, cs, st)
    errs.update(phase_kernels_const(dev, cs, st, A_div))
    phase_golden(dev, kt)
    phase_entry(dev, kt, st)
    launches = phase_main(dev, kt, cs, st, A_div)
    for more in (phase_const_cg(dev, kt, cs, st), phase_mg(dev, kt, cs, st)):
        for k in launches:
            launches[k] += more[k]
    errs.update(phase_sparse_kernels(dev, sv, bs))
    n_spmv, _ = phase_sparse_solves(dev, kt, sv)
    n_blocked, blocked_errs = phase_sparse_blocked(dev, kt, sv, bs)
    launches.update(csr_matvec=n_spmv, **n_blocked)
    for name, err in blocked_errs.items():
        errs[name] = max(errs[name], err)
    errs.update(phase_jacobi_kernels(dev, cs, st, A_div))
    for k, n in phase_jacobi_cg(dev, kt, cs, st, A_div).items():
        launches[k] += n
    n_family, _ = phase_family(dev, kt, sv)
    for k in ("csr_matvec", "csr_matmat"):
        launches[k] += n_family[k]
    phase_device_rule(kt, cs, sv, st)
    for k, n in phase_stationary(dev, kt, cs, sv, st, card).items():
        launches[k] += n
    n_prec, prec_errs = phase_preconditioners(dev, kt, sv, card)
    for k, n in n_prec.items():
        launches[k] += n
        errs[k] = max(errs[k], prec_errs[k])
    for k, n in phase_diffable(dev, kt, cs, sv, bs, st, A_div, card).items():
        launches[k] += n
    for k, n in phase_distributed_one(dev, kt, cs, sv, bs, st, card).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in phase_distributed_gloo(dev, kt, sv, st, card).items():
        launches[k] += n
    for k, n in phase_partitions_one(dev, kt, cs, sv, st, card).items():
        launches[k] += n
    for k, n in phase_partitions_gloo(dev, kt, sv, st, card).items():
        launches[k] += n
    for k, n in phase_graph_loop(dev, kt, cs, sv, bs, st, card).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in phase_kept(dev, kt, cs, sv, bs, st, card).items():
        launches[k] = launches.get(k, 0) + n
    times = phase_timing(dev, kt, cs, st, A_div, card)
    times.update(sparse_timing(dev, kt, sv, bs, card))

    stencil, spmv, bsr = (f"krylov_tpu_torch/csrc/{f}" for f in ("stencil.cu", "spmv.cu",
                                                                  "bsr.cu"))
    replaces = {
        "stencil2d_matvec": (stencil, "krylov_tpu/ops/pallas_stencil.py:144"),
        "const_stencil2d_matvec": (stencil, "krylov_tpu/ops/pallas_stencil.py:300"),
        "cg_fused_phase_a": (stencil, "krylov_tpu/ops/pallas_stencil.py:909"),
        "cg_fused_phase_b": (stencil, "krylov_tpu/ops/pallas_stencil.py:959"),
        "cg_fused_phase_a_var": (stencil, "krylov_tpu/ops/pallas_stencil.py:685"),
        "cg_fused_phase_a_var_jac": (stencil, "krylov_tpu/ops/pallas_stencil.py:787"),
        "cg_fused_phase_b_jac": (stencil, "krylov_tpu/ops/pallas_stencil.py:865"),
        "jacobi_sweep_const": (stencil, "krylov_tpu/ops/pallas_stencil.py:438"),
        "jacobi_sweep_var": (stencil, "krylov_tpu/ops/pallas_stencil.py:524"),
        "csr_matvec": (spmv, "krylov_tpu/ops/pallas_spmv.py:861"),
        "csr_matmat": (spmv, "krylov_tpu/ops/pallas_spmv.py:690"),
        "bsr_spmm": (bsr, "krylov_tpu/ops/pallas_bsr.py:58"),
    }
    unlaunched = [name for name in replaces if launches[name] == 0]
    assert not unlaunched, f"kernels no main path launched: {unlaunched}"
    kernels = []
    for name, (src, where) in replaces.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": where,
            "launches": launches[name], "max_abs_err": errs[name], **times[name],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
