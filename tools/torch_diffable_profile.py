#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` (differentiable solves and profiling)
alone, in a fresh process, and what the process's first backward pass
costs on the card.

Run from the root of the repository on a machine with one CUDA device:

    python3 tools/torch_diffable_profile.py

It builds the kernels, times a first and a second autograd backward of a
four-element product on the card (the engine's start-up, with no solve in
it) and a first and a second call of the torch operations K1's
coefficient gradient runs, takes the process's first backward through
``diffable.solve`` at 4096^2 apart (before, in and after its adjoint
solve) beside a warm one, runs phase 10 (``chip_smoke.phase_diffable``),
then 10a's 4096^2 float32 case once more, warm.  Every time is printed
beside the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def tiny_backward(dev):
    """Wall time of one synchronized backward of ``(2 a).sum()``."""
    a = torch.ones(4, device=dev, requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (2.0 * a).sum().backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def first_uses(dev, cs, card):
    """Wall time of the first and the second call in this process of the
    torch operations a first backward through ``diffable.solve`` runs that
    its forward did not (the loss's cast back to float32; K1's coefficient
    gradient: ``F.pad``, ``cat``, ``stack``) and of that gradient itself,
    on an 8 x 8 grid."""
    import torch.nn.functional as F

    x = torch.ones((8, 8), device=dev)
    xd = x.double()  # the loss's cast; its backward casts back
    for name, fn in (("float64 -> float32 copy", lambda: xd.float()),
                     ("F.pad", lambda: F.pad(x[:, 1:], (0, 1))),
                     ("torch.cat", lambda: torch.cat([x, x])),
                     ("torch.stack", lambda: torch.stack([x, x])),
                     ("stencil2d_coeffs_grad", lambda: cs.stencil2d_coeffs_grad(
                         x, x, (-1, 0, 1), (0, 1, 0)))):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        smoke.log(f"  [{card}] {name}: first call {times[0] * 1e3:.1f} ms, second "
                  f"{times[1] * 1e3:.3f} ms")


def first_backward_timeline(dev, kt, st, card):
    """The process's first backward through ``diffable.solve`` (10a's
    case at 4096^2), taken apart: from the backward's start to its adjoint
    solve's, the adjoint solve (with the gaps between its steps, from a
    callback), and from its end to the backward's; then the same once
    more, warm."""
    field = smoke.lognormal_field(smoke.BIG, smoke.SEED + 1).astype(np.float32)
    A = st.diffusion_2d(field, device=dev)
    M = kt.jacobi_preconditioner(A)
    rng = np.random.default_rng(smoke.SEED + 70)
    b, w = (A @ torch.from_numpy(rng.standard_normal(smoke.BIG ** 2).astype(np.float32)).to(dev)
            for _ in range(2))
    A.coeffs2d.requires_grad_()
    b.requires_grad_()
    for label in ("first", "warm"):
        marks, steps = {}, []

        def timed_cg(A_, b_, **kw):
            marks["adjoint start"] = time.perf_counter()
            out = kt.cg(A_, b_, callback=lambda x, r: steps.append(time.perf_counter()), **kw)
            torch.cuda.synchronize()
            marks["adjoint end"] = time.perf_counter()
            return out

        x = kt.diffable.solve(A, b, M=M, tol=smoke.DIFF_TOL, maxiter=5000, adjoint_solver=timed_cg)
        loss = smoke.f64_loss(w, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gaps = np.diff(np.asarray(steps)) * 1e3
        smoke.log(f"  [{card}] {label} diffable backward, {smoke.BIG}^2: {(t1 - t0) * 1e3:.1f} ms; "
                  f"to the adjoint solve {(marks['adjoint start'] - t0) * 1e3:.1f} ms, the solve "
                  f"{(marks['adjoint end'] - marks['adjoint start']) * 1e3:.1f} ms ({len(steps)} "
                  f"callbacks: to the first {(steps[0] - marks['adjoint start']) * 1e3:.1f} ms, "
                  f"gaps median {np.median(gaps):.3f} max {gaps.max():.1f} ms, the first five "
                  f"{np.round(gaps[:5], 2).tolist()}), after it {(t1 - marks['adjoint end']) * 1e3:.1f} ms")
        A.coeffs2d.grad = b.grad = None


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_diffable_profile: needs a CUDA device")
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_bsr as bs
    from krylov_tpu_torch.ops import cuda_spmv as sv
    from krylov_tpu_torch.ops import cuda_stencil as cs
    from krylov_tpu_torch.ops import stencil as st

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    _, seconds, _ = _build.build()
    smoke.log(f"{card}; kernels built in {seconds:.1f} s")
    first, second = tiny_backward(dev), tiny_backward(dev)
    smoke.log(f"  [{card}] the process's first autograd backward on the card "
              f"{first * 1e3:.1f} ms, the second {second * 1e3:.3f} ms")
    first_uses(dev, cs, card)
    first_backward_timeline(dev, kt, st, card)
    A_div = st.diffusion_2d(smoke.lognormal_field(smoke.BIG, smoke.SEED + 1)
                            .astype(np.float32), device=dev)
    t0 = time.perf_counter()
    launches = smoke.phase_diffable(dev, kt, cs, sv, bs, st, A_div, card)
    smoke.log(f"  phase 10: {time.perf_counter() - t0:.1f} s of wall; launches {launches}")
    smoke.log("  10a once more, warm:")
    smoke.stencil_gradient_case(dev, kt, cs, st, smoke.lognormal_field(smoke.BIG, smoke.SEED + 1),
                                np.float32, smoke.DIFF_TOL, 5000, 1e-2, smoke.SEED + 70, card)


if __name__ == "__main__":
    main()
