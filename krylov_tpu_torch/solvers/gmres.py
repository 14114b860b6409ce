"""Preconditioned GMRES (counterpart of ``krylov_tpu.solvers.gmres``).

``M``/``Ml``/``Mr`` preconditioning, any inner product, multi-RHS blocking,
``ortho`` in {"mgs", "mgs<N>", "cgs" (two passes), "cgs<N>",
"householder"} (householder needs the Euclidean inner product and no
``M``), ``restart=`` (GMRES(m)), per-iteration callback and the
``num_operations`` model.

Two drivers over the same mathematics:

* eager — host loop over the Arnoldi iterator classes (every ortho, custom
  inner products, the float64 parity mode);
* while_loop — fixed ``(maxiter + 1, N, ...)`` basis buffers (V and P, one
  buffer when ``M`` is the identity, since ``V = M P``), the Hessenberg
  factor R, the stored rotations G and the rotated right-hand side y, all
  on the device and written in place.  The step number is the driver's
  (:mod:`.._steps`): on the host a host integer, so the MGS sweep, the
  rotations and the Householder projections are Python loops that read
  nothing back and the only host read per step is the driver's stop flag;
  on the graph route the device counter, the loops WHILE nodes (the
  reference's ``fori_loop``), so a replayed step's work stays O(k).  CGS
  contracts against the basis in chunks of :data:`CGS_ROWS` rows, as many
  as hold rows ``0..k`` (a WHILE node on the graph route, a Python loop on
  the host): at most one chunk more than the k + 1 rows a contraction
  needs, the same shapes on both routes at any ``maxiter``.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._driver import EAGER, WHILE_LOOP, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Identity, Product
from ..arnoldi import ArnoldiCGS, ArnoldiHouseholder, ArnoldiMGS, padded_reflector_at
from .._steps import add_at, at, owned, put, put_col, put_head, rows
from ..givens import apply_givens, givens
from ..ops.triangular import multi_solve_triangular
from ._common import initial_residual, preconditioner, setup

# the basis rows a CGS contraction takes at a time (all of them when
# maxiter + 1 is fewer)
CGS_ROWS = 32


def _num_operations(k):
    return {
        "A": 1 + k,
        "M": 2 + k,
        "Ml": 2 + k,
        "Mr": 1 + k,
        "inner": 2 + k + k * (k + 1) / 2,
        "axpy": 4 + 2 * k + k * (k + 1) / 2,
    }


def gmres(
    A,
    b,
    M=None,
    Ml=None,
    Mr=None,
    inner: Optional[Callable] = None,
    ortho: str = "mgs",
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    restart: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
    batch_inner: Optional[Callable] = None,
):
    if restart is not None:
        return _gmres_restarted(
            A, b, M=M, Ml=Ml, Mr=Mr, inner=inner, ortho=ortho, x0=x0,
            tol=tol, atol=atol, maxiter=maxiter, restart=restart,
            callback=callback, backend=backend, batch_inner=batch_inner,
        )
    inner_is_none = inner is None
    if maxiter is None:
        bshape = tuple(np.shape(b))
        # rows only: right-hand-side columns scale the basis linearly
        if bshape and int(bshape[0]) >= (1 << 13):
            import warnings

            n_rhs = int(np.prod(bshape[1:])) if len(bshape) > 1 else 1
            warnings.warn(
                "full GMRES with maxiter=None allocates an O(N^2) basis "
                f"(N = {int(bshape[0])}"
                + (f", x{n_rhs} RHS columns" if n_rhs > 1 else "")
                + "); pass maxiter= or use restart= (GMRES(m)) at this "
                "scale",
                stacklevel=2,
            )
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)
    Ml = preconditioner(Ml, b.device)
    Mr = preconditioner(Mr, b.device)
    Ml_A_Mr = Product(Ml, A, Mr)

    def residual_norm(z):
        Ml_r = Ml @ (b - A @ z)
        return torch.sqrt(ensure_real(inner(Ml_r, M @ Ml_r), "<x, M x>"))

    r0 = initial_residual(A, b, x0, x0_default)
    Ml_r0 = Ml @ r0
    M_Ml_r0 = M @ Ml_r0
    norm0 = torch.sqrt(ensure_real(inner(Ml_r0, M_Ml_r0), "<x, M x>"))

    if callback is not None:
        callback(x0, norm0)

    common = dict(
        A=A, b=b, x0=x0, M=M, Ml=Ml, Mr=Mr, Ml_A_Mr=Ml_A_Mr, inner=inner,
        residual_norm=residual_norm, Ml_r0=Ml_r0, M_Ml_r0=M_Ml_r0, norm0=norm0,
        tol=tol, atol=atol, maxiter=maxiter, callback=callback,
    )

    if backend == WHILE_LOOP:
        if ortho == "householder":
            if not inner_is_none:
                raise ValueError("ortho='householder' requires the default inner product")
            if not isinstance(M, Identity):
                raise ValueError("ortho='householder' does not support M")
            return _gmres_while_householder(**common)
        if ortho.startswith("cgs"):
            num_passes = 2 if len(ortho) == 3 else int(ortho[3:])
            return _gmres_while(
                num_reorthos=num_passes, cgs=True,
                batch_inner=_make_batch_inner(batch_inner, inner, inner_is_none),
                **common,
            )
        if not ortho.startswith("mgs"):
            raise ValueError(f"unknown orthogonalization {ortho!r}")
        num_reorthos = 1 if len(ortho) == 3 else int(ortho[3:])
        return _gmres_while(num_reorthos=num_reorthos, **common)
    if backend != EAGER:
        raise ValueError(f"unknown backend {backend!r}")
    return _gmres_eager(ortho=ortho, inner_is_none=inner_is_none, **common)


def _make_batch_inner(batch_inner, inner, inner_is_none):
    """Basis-against-vector inner products for CGS sweeps: ``batch(Vb, w)``
    contracts a stacked ``(j, N, *tail)`` basis against one vector.  One
    einsum for the Euclidean inner; the user inner per basis vector
    otherwise."""
    if batch_inner is not None:
        return batch_inner
    if inner_is_none:
        return lambda Vb, w: torch.einsum("kn...,n...->k...", Vb.conj(), w)
    return lambda Vb, w: torch.stack([inner(v, w) for v in Vb])


def _gmres_restarted(
    A, b, *, M, Ml, Mr, inner, ortho, x0, tol, atol, maxiter, restart,
    callback, backend, batch_inner=None,
):
    """GMRES(m): restart every ``restart`` iterations.

    Convergence is judged against the criterion of the initial residual
    (``max(tol * resnorm0, atol)``, per right-hand-side column), so the
    trajectories of the cycles concatenate; entry 0 of each later cycle is
    the explicit residual of the restart iterate and is dropped.
    """
    N = np.shape(b)[0]
    total_max = N if maxiter is None else maxiter
    m = min(restart, total_max)

    x = x0
    resnorms = None
    criterion = None
    numsteps = 0
    success = False
    while True:
        cycle_max = min(m, total_max - numsteps)
        kw = dict(
            M=M, Ml=Ml, Mr=Mr, inner=inner, ortho=ortho, x0=x,
            maxiter=cycle_max, callback=callback, backend=backend,
            batch_inner=batch_inner,
        )
        if criterion is None:
            sol, info = gmres(A, b, tol=tol, atol=atol, **kw)
            criterion = np.maximum(tol * np.asarray(info.resnorms[0]), atol)
            resnorms = np.asarray(info.resnorms)
        else:
            sol, info = gmres(A, b, tol=0.0, atol=criterion, **kw)
            resnorms = np.concatenate([resnorms, np.asarray(info.resnorms)[1:]])
        numsteps += info.numsteps
        x = info.xk
        success = bool(info.success)
        if success or numsteps >= total_max or info.numsteps == 0:
            break

    info = Info(success, x, numsteps, resnorms, _num_operations(numsteps))
    return (x if success else None), info


class _EagerState(NamedTuple):
    R: torch.Tensor
    y: torch.Tensor
    resnorm: torch.Tensor


def _gmres_eager(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback, ortho, inner_is_none,
):
    if ortho.startswith("mgs"):
        num_reorthos = 1 if len(ortho) == 3 else int(ortho[3:])
        arnoldi = ArnoldiMGS(Ml_A_Mr, Ml_r0, num_reorthos=num_reorthos, M=M,
                             Mv=M_Ml_r0, Mv_norm=norm0, inner=inner)
    elif ortho.startswith("cgs"):
        num_passes = 2 if len(ortho) == 3 else int(ortho[3:])
        arnoldi = ArnoldiCGS(Ml_A_Mr, Ml_r0, num_passes=num_passes, M=M,
                             Mv=M_Ml_r0, Mv_norm=norm0, inner=inner)
    elif ortho == "householder":
        if not inner_is_none:
            raise ValueError("ortho='householder' requires the default inner product")
        if not isinstance(M, Identity):
            raise ValueError("ortho='householder' does not support M")
        arnoldi = ArnoldiHouseholder(Ml_A_Mr, Ml_r0)
    else:
        raise ValueError(f"unknown orthogonalization {ortho!r}")

    dtype = M_Ml_r0.dtype
    dev = M_Ml_r0.device
    tail = tuple(norm0.shape)
    R0 = torch.zeros((maxiter + 1, maxiter) + tail, dtype=dtype, device=dev)
    y0 = torch.zeros((maxiter + 1,) + tail, dtype=dtype, device=dev)
    y0[0] = norm0
    G = []  # rotation history (host list)

    def step(s: _EagerState, criterion) -> _EagerState:
        k = arnoldi.iter
        _, h = next(arnoldi)
        R = s.R.clone()
        R[: k + 2, k] = h[: k + 2]
        for i in range(k):
            R[i: i + 2, k] = apply_givens(G[i], R[i: i + 2, k])
        g, r = givens(R[k: k + 2, k])
        G.append(g)
        R[k, k] = r
        R[k + 1, k] = 0.0
        ypair = apply_givens(g, s.y[k: k + 2])
        y = s.y.clone()
        y[k: k + 2] = ypair
        return _EagerState(R=R, y=y, resnorm=ypair[1].abs())

    def xk_of(s: _EagerState):
        kk = arnoldi.iter
        if kk == 0:
            return x0
        yy = multi_solve_triangular(s.R[:kk, :kk], s.y[:kk])
        yk = sum(c * v for c, v in zip(yy, arnoldi.V))
        return x0 + Mr @ yk

    method = Method(
        step=step,
        xk=xk_of,
        explicit_resnorm=residual_norm,
        callback_args=lambda s: (xk_of(s), s.resnorm),
    )
    state0 = _EagerState(R=R0, y=y0, resnorm=norm0)
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=EAGER,
    )
    xk = xk_of(state)
    info = Info(success, xk, k, resnorms, _num_operations(k))
    return xk if success else None, info


def _givens_qr_update(G, R, y, h, ctl):
    """Fold the Hessenberg column ``h`` into the running Givens QR, in
    place: apply the ``k`` stored rotations to it (``k = ctl.k``), store
    the rotation that annihilates its subdiagonal entry, write column ``k``
    of R and rotate ``y``.  Returns ``|y[k+1]|``, the GMRES residual-norm
    recurrence."""
    k = ctl.k
    c = h.clone()

    def rotate(i):
        put(c, i, apply_givens(at(G, i), rows(c, i, 2)), n=2)

    ctl.loop(k, rotate)
    g, r = givens(rows(c, k, 2))
    put(c, k, r)
    put(c, k + 1, 0.0)
    put_col(R[:-1], k, c[:-1])
    put(G, k, g)
    ypair = apply_givens(g, rows(y, k, 2))
    put(y, k, ypair, n=2)
    return ypair[1].abs()


def _eye2_rotations(K, tail, dtype, device):
    eye2 = torch.eye(2, dtype=dtype, device=device).reshape((1, 2, 2) + (1,) * len(tail))
    return eye2.expand((K, 2, 2) + tail).clone()


def _solution(s, kk, x0, Mr):
    """``x0 + Mr V_k y_k`` with ``R_k y_k = y[:k]`` (``kk`` the step count)."""
    if kk == 0:
        yk = torch.zeros_like(s.V[0])
    else:
        yy = multi_solve_triangular(s.R[:kk, :kk], s.y[:kk])
        yk = torch.einsum("k...,kn...->n...", yy, s.V[:kk])
    return x0 + Mr @ yk


def _padded_solution(s, k, x0, Mr):
    """``x0 + Mr V y`` with the ``K x K`` system padded beyond step ``k``
    (an int, or the graph route's 0-d device counter): a unit diagonal and
    a zero right-hand side there decouple exactly, so no size depends on
    ``k`` and nothing is read on the host (the reference's device form, a
    callback's ``x`` on both routes of ``while_loop``)."""
    K = s.R.shape[1]
    tail = (1,) * (s.y.ndim - 1)
    active = torch.arange(K, device=s.R.device) < k
    fix = torch.diag((~active).to(s.R.dtype)).reshape((K, K) + tail)
    yv = torch.where(active.reshape((K,) + tail), s.y[:K], torch.zeros_like(s.y[:K]))
    yy = multi_solve_triangular(s.R[:K] + fix, yv)
    return x0 + Mr @ torch.einsum("k...,kn...->n...", yy, s.V[:K])


class _WhileState(NamedTuple):
    V: torch.Tensor  # (K+1, N, *tail) M-preconditioned basis
    P: torch.Tensor  # (K+1, N, *tail) dual basis, V = M P (empty if M = I: V)
    R: torch.Tensor  # (K+1, K, *tail) triangular factor
    G: torch.Tensor  # (K, 2, 2, *tail) rotation history
    y: torch.Tensor  # (K+1, *tail) rotated projected rhs
    resnorm: torch.Tensor
    # (width, 1, ...) a CGS chunk's row numbers: in the state, so that a
    # graph kept across solves (make_sharded_solver) reads no tensor of one
    lanes: torch.Tensor


def _finish(state, success, k, resnorms, xk_of):
    xk = xk_of(state, k)
    info = Info(success, xk, k, resnorms, _num_operations(k))
    return (xk if success else None), info


def _gmres_while(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback, num_reorthos, cgs=False,
    batch_inner=None,
):
    K = maxiter
    tail = tuple(norm0.shape)
    dtype = M_Ml_r0.dtype
    dev = b.device
    safe0 = torch.where(norm0 != 0.0, norm0, 1.0)
    V0 = torch.zeros((K + 1,) + tuple(b.shape), dtype=dtype, device=dev)
    V0[0] = M_Ml_r0 / safe0
    same = isinstance(M, Identity)  # V = M P = P: one buffer
    if same:
        P0 = V0.new_zeros(0)
    else:
        P0 = torch.zeros_like(V0)
        P0[0] = Ml_r0 / safe0
    R0 = torch.zeros((K + 1, K) + tail, dtype=dtype, device=dev)
    y0 = torch.zeros((K + 1,) + tail, dtype=dtype, device=dev)
    y0[0] = norm0
    width = min(CGS_ROWS, K + 1)  # the rows of a CGS chunk
    last = K + 1 - width  # the first row of the basis's last whole chunk
    lanes = torch.arange(width, device=dev).reshape((width,) + (1,) * len(tail))
    state0 = _WhileState(V=V0, P=P0, R=R0, G=_eye2_rotations(K, tail, dtype, dev),
                         y=y0, resnorm=norm0, lanes=lanes)

    def chunk(c, lanes):
        """The first row of CGS chunk ``c`` (rows ``c * width ..``) and the
        mask of the rows that are its own, or None for all of them: a chunk
        that would run past the basis starts at ``last`` instead, over rows
        of the chunk before it."""
        start = c * width
        if isinstance(c, int):
            return (start, None) if start <= last else (last, lanes >= start - last)
        first = torch.clamp(start, max=last)
        return first, lanes >= start - first

    def step(s: _WhileState, criterion, ctl) -> _WhileState:
        k = ctl.k
        P = s.V if same else s.P
        # the sweeps write Av in place
        Av = owned(Ml_A_Mr @ at(s.V, k), s.V)
        h = torch.zeros((K + 1,) + tail, dtype=dtype, device=dev)
        if cgs:
            # classical Gram-Schmidt: per pass, the coefficients of rows
            # 0..k against Av, then Av less their combination, each by the
            # chunks that hold those rows (rows past k are still zero)
            def coefficients(c):
                first, own = chunk(c, s.lanes)
                alphas = batch_inner(rows(s.V, first, width), Av)
                add_at(a, first, alphas if own is None else torch.where(own, alphas, 0),
                       n=width)

            def combine(c):
                first, own = chunk(c, s.lanes)
                alphas = rows(a, first, width)
                if own is not None:
                    alphas = torch.where(own, alphas, 0)
                Av.sub_(torch.einsum("k...,kn...->n...", alphas, rows(P, first, width)))

            chunks = k // width + 1
            for _ in range(num_reorthos):
                a = torch.zeros((K + 1,) + tail, dtype=dtype, device=dev)
                ctl.loop(chunks, coefficients)
                ctl.loop(chunks, combine)
                h.add_(a)
        else:
            def mgs(j):
                Vj = at(s.V, j)
                alpha = inner(Vj, Av)
                add_at(h, j, alpha)
                Av.sub_(alpha * (Vj if same else at(P, j)))

            for _ in range(num_reorthos):
                ctl.loop(k + 1, mgs)
        MAv = M @ Av
        hk1 = torch.sqrt(inner(Av, MAv))
        put(h, k + 1, hk1)
        safe = torch.where(hk1 != 0.0, hk1, 1.0)
        put(s.V, k + 1, MAv / safe)
        if not same:
            put(s.P, k + 1, Av / safe)
        resnorm = _givens_qr_update(s.G, s.R, s.y, h, ctl)
        return s._replace(resnorm=resnorm)

    def xk_of(s, k):
        return _solution(s, k, x0, Mr)

    method = Method(step=step, xk=xk_of, explicit_resnorm=residual_norm,
                    callback_args=lambda s, k: (_padded_solution(s, k, x0, Mr), s.resnorm),
                    capturable=True, counted=True)
    state, success, k, resnorms = run(state0, method, tol=tol, atol=atol,
                                      maxiter=maxiter, callback=callback,
                                      backend=WHILE_LOOP)
    return _finish(state, success, k, resnorms, xk_of)


class _WhileHouseState(NamedTuple):
    V: torch.Tensor  # (K+1, N, *tail) orthonormal basis (reconstructed)
    U: torch.Tensor  # (K+2, N, *tail) padded reflector directions
    betas: torch.Tensor  # (K+2, *tail)
    alphas: torch.Tensor  # (K+2, *tail) phase factors
    R: torch.Tensor  # (K+1, K, *tail) triangular factor
    G: torch.Tensor  # (K, 2, 2, *tail) rotation history
    y: torch.Tensor  # (K+1, *tail) rotated projected rhs
    resnorm: torch.Tensor


def _gmres_while_householder(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback,
):
    """Householder-Arnoldi GMRES on device buffers: reflectors stored as
    full-length vectors that are zero above their pivot, so the projection
    sweep and the basis reconstruction are chains of whole-vector
    updates."""
    K = maxiter
    N = b.shape[0]
    tail = tuple(norm0.shape)
    dtype = M_Ml_r0.dtype
    dev = b.device

    def reflect(u, beta, w):
        """``w`` reflected by ``(u, beta)``, in place."""
        w.sub_(beta * u * torch.sum(u.conj() * w, dim=0))

    r0 = Ml_r0.to(dtype)
    u0, b0, a0, _ = padded_reflector_at(r0, 0)
    safe0 = torch.where(norm0 != 0.0, norm0, 1.0)
    V0 = torch.zeros((K + 1,) + tuple(b.shape), dtype=dtype, device=dev)
    V0[0] = r0 / safe0
    U0 = torch.zeros((K + 2,) + tuple(b.shape), dtype=dtype, device=dev)
    U0[0] = u0
    betas0 = torch.zeros((K + 2,) + tail, dtype=dtype, device=dev)
    betas0[0] = b0
    alphas0 = torch.zeros((K + 2,) + tail, dtype=dtype, device=dev)
    alphas0[0] = a0
    R0 = torch.zeros((K + 1, K) + tail, dtype=dtype, device=dev)
    y0 = torch.zeros((K + 1,) + tail, dtype=dtype, device=dev)
    y0[0] = norm0
    state0 = _WhileHouseState(V=V0, U=U0, betas=betas0, alphas=alphas0, R=R0,
                              G=_eye2_rotations(K, tail, dtype, dev), y=y0,
                              resnorm=norm0)

    def step(s: _WhileHouseState, criterion, ctl) -> _WhileHouseState:
        k = ctl.k
        # the projections write w in place
        w = owned((Ml_A_Mr @ at(s.V, k)).to(dtype), s.V)

        def project(j):  # reflector j, fixing the phase of entry j
            reflect(at(s.U, j), at(s.betas, j), w)
            put(w, j, at(w, j) * at(s.alphas, j).conj())

        # forward projection: reflectors 0..k
        ctl.loop(k + 1, project)
        # new reflector annihilating w below position k + 1 (none past N)
        u, beta, alpha, xnorm = padded_reflector_at(w, k + 1)
        put(s.U, k + 1, u)
        put(s.betas, k + 1, beta)
        put(s.alphas, k + 1, alpha)
        reflect(u, beta.to(dtype), w)
        ctl.cond(k + 1 < N, lambda: put(w, k + 1, at(w, k + 1) * alpha.conj()))
        # Hessenberg column: entries 0..k, then |w[k+1]| = xnorm
        h = torch.zeros((K + 1,) + tail, dtype=dtype, device=dev)
        put_head(h, k + 1, w)
        put(h, k + 1, xnorm)
        # basis vector k + 1: reflectors k+1..0 applied to e_{k+1}, scaled by
        # the newest phase
        e = torch.zeros(tuple(b.shape), dtype=dtype, device=dev)
        ctl.cond(k + 1 < N, lambda: put(e, k + 1, 1.0))
        ctl.loop(k + 2, lambda i: reflect(at(s.U, k + 1 - i), at(s.betas, k + 1 - i), e))
        put(s.V, k + 1, e * at(s.alphas, k + 1))
        resnorm = _givens_qr_update(s.G, s.R, s.y, h, ctl)
        return s._replace(resnorm=resnorm)

    def xk_of(s, k):
        return _solution(s, k, x0, Mr)

    method = Method(step=step, xk=xk_of, explicit_resnorm=residual_norm,
                    callback_args=lambda s, k: (_padded_solution(s, k, x0, Mr), s.resnorm),
                    capturable=True, counted=True)
    state, success, k, resnorms = run(state0, method, tol=tol, atol=atol,
                                      maxiter=maxiter, callback=callback,
                                      backend=WHILE_LOOP)
    return _finish(state, success, k, resnorms, xk_of)
