#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of the repository, with nothing built beforehand:

    python3 chip_smoke.py

It needs one CUDA device (Hopper: the kernels are built for sm_90a) and
``nvcc``, and imports only torch, numpy and ``krylov_tpu_torch``.  Phases,
in order; any failure raises, so the exit code is nonzero:

0. device line (``nvidia-smi`` name and power limit), versions, kernel build;
1. every kernel (K1 stencil matvec, K5 / K4 fused CG phases) against its
   plain PyTorch version on the card, at small odd shapes and at the main
   path's 4096^2 shape;
2. golden CG in float64 on ``diag([1e-3, 2..100])``;
3. the twin of ``__graft_entry__.entry()`` (compiled CG on ``poisson_2d(128)``)
   and a converging solve of the same operator;
4. the main path at 4096^2 (16.7M rows): 100 iterations of ``cg``
   (``while_loop``) and of ``cg_stencil(fused=True)`` on ``poisson_2d`` and
   on ``diffusion_2d`` with lognormal coefficients, with launch counts,
   trajectory agreement and bitwise repeatability; at 1024^2 the kernel
   trajectory against a float64 CPU run of the plain versions;
5. timings with CUDA events, each printed beside the card's name and power
   limit.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

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


def max_err(got, want):
    return float((got.double() - want.double()).abs().max())


def check_close(name, got, want, atol, rtol=0.0):
    err = max_err(got, want)
    bound = atol + rtol * float(want.double().abs().max())
    ok = bool(
        ((got.double() - want.double()).abs()
         <= atol + rtol * want.double().abs()).all()
    )
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol {rtol:g}, "
        f"bound at max {bound:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


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


def check_fused(name, got, want):
    """Vectors at 1e-5 of their max; the reduced scalar at rtol 1e-4, the
    f32 summation-order band over 16.7M terms."""
    err = 0.0
    for k, (g, w) in enumerate(zip(got[:2], want[:2])):
        err = max(err, check_close(f"{name} out{k}", g, w,
                                   atol=1e-5 * float(w.abs().max())))
    check_close(f"{name} scalar", got[2], want[2], atol=0.0, rtol=1e-4)
    return err


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
        counts.append(dict(cs.LAUNCHES))
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
        A_gpu, A_cpu = make(np.float32, dev), make(np.float64, None)
        b = torch.ones(A_gpu.grid, dtype=torch.float32, device=dev)
        (g_cg, g_fu), _ = solve_pair(A_gpu, b, kt, cs, iters)
        _, ref = kt.cg_stencil(A_cpu, b.double().cpu(), tol=0.0, atol=0.0,
                               maxiter=iters)
        for name, info in (("cg", g_cg), ("fused", g_fu)):
            agree(f"{label} {name} f32 GPU vs f64 CPU", info, ref, steps)
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
    for label, A in (("poisson_2d", A_p), ("diffusion_2d", A_div)):
        c, ro, co = A.coeffs2d, A.row_offsets, A.col_offsets
        nd = c.shape[0]
        k1 = time_ms(lambda: cs.stencil2d_matvec(c, x, ro, co, out=y), 50)
        k1p = time_ms(lambda: cs.stencil2d_matvec_plain(c, x, ro, co), 10)
        k5 = time_ms(lambda: cs.cg_fused_phase_a_var(om, r, x, c, ro, co,
                                                     out=(pn, ap)), 50)
        k5p = time_ms(lambda: cs.cg_fused_phase_a_var_plain(om, r, x, c, ro, co), 10)
        gbs = lambda ms, words: words * N * 4 / (ms * 1e-3) / 1e9  # noqa: E731
        log(f"  [{card}] {label} {BIG}^2 K1 stencil2d_matvec {k1 * 1e3:.1f} us "
            f"({gbs(k1, nd + 2):.0f} GB/s by the (ndiag+2)*N*4 byte model); "
            f"plain {k1p * 1e3:.1f} us")
        log(f"  [{card}] {label} {BIG}^2 K5 cg_fused_phase_a_var {k5 * 1e3:.1f} us "
            f"({gbs(k5, nd + 4):.0f} GB/s by (ndiag+4)*N*4); plain {k5p * 1e3:.1f} us")
        times[label] = {"stencil2d_matvec": (k1, k1p), "cg_fused_phase_a_var": (k5, k5p)}
    yv, rv = x.clone(), r.clone()
    k4 = time_ms(lambda: cs.cg_fused_phase_b(al, yv, rv, x, r), 50)
    k4p = time_ms(lambda: cs.cg_fused_phase_b_plain(al, yv, rv, x, r), 10)
    log(f"  [{card}] {BIG}^2 K4 cg_fused_phase_b {k4 * 1e3:.1f} us "
        f"({6 * N * 4 / (k4 * 1e-3) / 1e9:.0f} GB/s by 6*N*4); plain {k4p * 1e3:.1f} us")
    times["diffusion_2d"]["cg_fused_phase_b"] = (k4, k4p)

    # marginal per-iteration cost: slope of whole-solve time over maxiter
    for label, A in (("poisson_2d", A_p), ("diffusion_2d", A_div)):
        b = torch.ones(A.grid, dtype=torch.float32, device=dev)
        for name, solve in (
            ("cg", lambda n: kt.cg(A, b, inner=inner, tol=0.0, atol=0.0,
                                   maxiter=n, backend="while_loop")),
            ("cg_stencil fused", lambda n: kt.cg_stencil(
                A, b, tol=0.0, atol=0.0, maxiter=n, fused=True)),
        ):
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
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
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
    phase_golden(dev, kt)
    phase_entry(dev, kt, st)
    launches = phase_main(dev, kt, cs, st, A_div)
    times = phase_timing(dev, kt, cs, st, A_div, card)

    src = "krylov_tpu_torch/csrc/stencil.cu"
    replaces = {
        "stencil2d_matvec": "krylov_tpu/ops/pallas_stencil.py:144",
        "cg_fused_phase_a_var": "krylov_tpu/ops/pallas_stencil.py:685",
        "cg_fused_phase_b": "krylov_tpu/ops/pallas_stencil.py:959",
    }
    kernels = []
    for name, where in replaces.items():
        ms, plain_ms = times["diffusion_2d"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": where,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms,
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
