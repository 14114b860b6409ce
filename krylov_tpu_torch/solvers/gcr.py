"""GCR — generalized conjugate residual (Eisenstat, Elman, Schultz 1983);
counterpart of ``krylov_tpu.solvers.gcr``.

Grows the s/v direction bases and orthogonalizes each new A-image against
all previous ones by modified Gram-Schmidt.  One buffered implementation
serves both backends: the bases live in fixed ``(maxiter, *b.shape)``
tensors on the solve's device, written in place, and the sweep's trip count
is the step number the driver gives the step (:mod:`.._steps`): a Python
loop on the host, a WHILE node on the device counter on the graph route
(the reference's ``fori_loop(0, k)``), so a step reads nothing back and its
device work stays O(k).  ``maxiter`` defaults to N.

``M`` is a (flexible) preconditioner: search directions become
``s_k = M r_k``; since the A-images are orthonormalized explicitly, even a
non-constant ``M`` is admissible.  ``M=None`` is the plain method.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._steps import at, owned, put
from ._common import nonzero, preconditioner, setup


class GcrState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    S: torch.Tensor  # (maxiter, N, *tail) search directions
    V: torch.Tensor  # (maxiter, N, *tail) their A-images, orthonormalized
    resnorm: torch.Tensor
    # in the state, so that a graph kept across solves (make_sharded_solver)
    # reads the solve's own right-hand side
    b: torch.Tensor


def gcr(
    A,
    b,
    M=None,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M, b.device)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, x), "<x, x>"))

    r0 = b if x0_default else b - A @ x0

    if callback is not None:
        callback(x0, r0)

    a_dtype = getattr(A, "dtype", None)
    vdtype = torch.promote_types(
        r0.dtype, a_dtype if isinstance(a_dtype, torch.dtype) else torch.float64)
    state0 = GcrState(
        x=x0.to(vdtype),
        r=r0.to(vdtype),
        S=torch.zeros((maxiter,) + tuple(b.shape), dtype=vdtype, device=b.device),
        V=torch.zeros((maxiter,) + tuple(b.shape), dtype=vdtype, device=b.device),
        resnorm=_norm(r0),
        b=b,
    )

    def step(st: GcrState, criterion, ctl) -> GcrState:
        k = ctl.k
        # the sweep writes both in place (M = I returns st.r itself)
        s_new = owned((M @ st.r).to(vdtype), st.r)
        v_new = owned((A @ s_new).to(vdtype), s_new)

        def mgs(i):
            Vi = at(st.V, i)
            alpha = inner(v_new, Vi)
            v_new.sub_(alpha * Vi)
            s_new.sub_(alpha * at(st.S, i))  # keep A s == v

        ctl.loop(k, mgs)

        safe = nonzero(_norm(v_new))
        v_new = v_new / safe
        s_new = s_new / safe

        gamma = inner(st.b, v_new)
        x = st.x + gamma * s_new
        r = st.r - gamma * v_new
        # the bases are written in place: row k is read by later steps only
        put(st.S, k, s_new)
        put(st.V, k, v_new)
        return GcrState(x=x, r=r, S=st.S, V=st.V, resnorm=_norm(r), b=st.b)

    method = Method(
        step=step,
        xk=lambda s, k: s.x,
        explicit_resnorm=lambda xk: _norm(b - A @ xk),
        callback_args=lambda s, k: (s.x, s.r),
        capturable=True,
        counted=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)
