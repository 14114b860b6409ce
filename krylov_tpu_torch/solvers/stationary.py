"""Stationary iterative methods: Richardson, Jacobi, Gauss-Seidel, SOR, SSOR
(counterpart of ``krylov_tpu.solvers.stationary``).

One shared loop iterates ``x += update(r); r = b - A x`` with no explicit
residual re-check: the recurrence is the explicit residual here.

Triangular sweeps, by operator type:

* :class:`~krylov_tpu_torch.ops.stencil.GridStencilOperator`: the grid
  sweeps of ``ops/triangular.py`` (on the card one launch of S1 a sweep; on
  the CPU a loop over grid rows, the within-row recurrence by doubling
  steps), no dense matrix at any size; a multi-RHS ``(N, k)`` residual is
  swept as one batch;
* scipy matrices and :class:`~krylov_tpu_torch.ops.sparse.CSROperator`
  above ``_DENSE_SWEEP_MAX`` rows: the level-scheduled sweep (on the card
  S2, a launch for each run of narrow levels and each wide level; on the
  CPU one data-parallel stage per dependency level).  The triangle is taken
  from the matrix as it was passed in, before ``as_operator`` routes it;
* everything else: a dense ``torch.linalg.solve_triangular``, which reads
  only the requested triangle.

No route reads a device value on the host, so every method here is
capturable: on a CUDA device a ``while_loop`` solve takes the graph route
under the driver's cost rule.  Everything a sweep holds lives on the
solve's device: the right-hand side's when it is a tensor, else the
operator's, else the default device.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import _device
from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import MatrixOperator, as_operator
from ._common import setup

_DENSE_SWEEP_MAX = 8192


class StationaryState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    resnorm: torch.Tensor
    # the right-hand side and the update's own tensor (Jacobi's diagonal;
    # empty for the others): in the state, so that a graph kept across
    # solves (make_sharded_solver) reads the solve's own
    b: torch.Tensor
    aux: torch.Tensor


def _stationary(
    update,
    A,
    b,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
    _aux: Optional[torch.Tensor] = None,
):
    # Every update reads nothing on the host (Richardson, Jacobi, and the
    # sweeps: S1, S2 or a dense solve_triangular), so the method is
    # capturable.  _aux: a tensor the state carries, handed to the update
    # as update(r, aux)
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)

    def _norm(x):
        return torch.sqrt(ensure_real(inner(x, x), "<x, x>"))

    r0 = b if x0_default else b - A @ x0

    if callback is not None:
        callback(x0, r0)

    aux = b.new_empty(0) if _aux is None else _aux
    state0 = StationaryState(x=x0.to(r0.dtype), r=r0, resnorm=_norm(r0), b=b, aux=aux)

    def step(s: StationaryState, criterion) -> StationaryState:
        x = s.x + (update(s.r) if _aux is None else update(s.r, s.aux))
        r = s.b - A @ x
        return StationaryState(x=x, r=r, resnorm=_norm(r), b=s.b, aux=s.aux)

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=None,  # stationary methods skip the double-check
        callback_args=lambda s: (s.x, s.r),
        capturable=True,
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    return (state.x if success else None), Info(success, state.x, k, resnorms)


def _solve_device(A, args=(), kwargs=None):
    """The device a solve of ``A`` with these arguments runs on, by
    ``setup``'s rule: the right-hand side's when it is a tensor, else the
    operator's, else the default device."""
    b = args[0] if args else (kwargs or {}).get("b")
    if isinstance(b, torch.Tensor):
        return b.device
    return _device.resolve(_device.device_of(A))


def _is_scipy_sparse(A):
    return hasattr(A, "tocsr") and not hasattr(A, "matvec")


def _dense_matrix(A, device):
    """A dense matrix on ``device`` for small triangular sweeps."""
    if _is_scipy_sparse(A):
        return torch.as_tensor(A.toarray(), device=device)
    op = as_operator(A, device)
    if isinstance(op, MatrixOperator):
        return op.a
    if hasattr(op, "todense"):
        if op.shape[0] > _DENSE_SWEEP_MAX:
            raise NotImplementedError(
                f"triangular sweeps above {_DENSE_SWEEP_MAX} rows are not "
                "materialized densely for this operator type; pass the "
                "scipy matrix (level-scheduled path) or use the "
                "grid-stencil/smoother forms"
            )
        return _device.as_tensor(op.todense(), device)
    raise ValueError("Gauss-Seidel/SOR/SSOR need a matrix (not a bare operator)")


def _sparse_for_levels(A):
    """A host scipy CSR when ``A`` is sparse and too large to densify.

    Checked on the original input, before ``as_operator`` routes it: on a
    CUDA device a large scipy matrix becomes a ``PETOperator``, whose CSR
    arrays may be permuted."""
    import scipy.sparse

    if _is_scipy_sparse(A):
        sp = A.tocsr()
        return sp if sp.shape[0] > _DENSE_SWEEP_MAX else None
    from ..ops.sparse import CSROperator

    if isinstance(A, CSROperator) and A.shape[0] > _DENSE_SWEEP_MAX:
        return scipy.sparse.csr_matrix(
            (A.data.cpu().numpy(), A.indices.cpu().numpy(), A.indptr.cpu().numpy()),
            shape=A.shape,
        )
    return None


def _level_solve(sp_csr, lower, device, diag_scale=None):
    """Level-scheduled solve of the (diag-rescaled) triangle of ``sp_csr``
    (see :func:`~krylov_tpu_torch.ops.triangular.make_triangular_solve`)."""
    import scipy.sparse

    from ..ops.triangular import make_triangular_solve

    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(sp_csr).tocsr()
    if diag_scale is not None:
        tri = tri.copy()
        tri.setdiag(tri.diagonal() / diag_scale)
    return make_triangular_solve(tri, lower=lower, max_levels=1024, device=device)


def _diagonal(A, device):
    op = as_operator(A, device)
    if hasattr(op, "diagonal"):
        return _device.as_tensor(op.diagonal(), device)
    raise ValueError("operator does not expose a diagonal()")


def _bcast(d, r):
    if d.numel() == r.numel():
        # operator-native vector shapes (e.g. grid-shaped (M, ny)): the
        # diagonal aligns elementwise with the residual
        return d.reshape(r.shape)
    # flat multi-RHS: diagonal broadcasts over trailing RHS columns
    return d.reshape((-1,) + (1,) * (r.ndim - 1))


def richardson(*args, omega: float = 1.0, **kwargs):
    """x_{k+1} = x_k + omega * r."""
    return _stationary(lambda r: omega * r, *args, **kwargs)


def jacobi(A, *args, omega: float = 1.0, **kwargs):
    """x_{k+1} = x_k + omega * D^{-1} r."""
    D = _diagonal(A, _solve_device(A, args, kwargs))

    def _update(r, D):
        return omega * r / _bcast(D, r)

    return _stationary(_update, A, *args, _aux=D, **kwargs)


def _is_grid_stencil(A):
    from ..ops.stencil import GridStencilOperator

    if isinstance(A, GridStencilOperator):
        return True
    # a rank's slab of a row-partitioned grid stencil
    # (parallel.ShardedGridStencilOperator): sweeps run on the slab with
    # block-Jacobi boundaries between ranks, the hybrid smoother (the
    # lower coupling across slabs is dropped, unlike the exact sweep)
    return isinstance(getattr(A, "_local", None), GridStencilOperator)


def _grid_sweep_update(A, omega_diag, lower):
    """Triangular-sweep update for a GridStencilOperator at any scale: the
    grid sweeps of ``ops/triangular.py``, prepared once; works on flat,
    grid-shaped and multi-RHS vectors.  For a rank's slab the sweep is
    local (block-Jacobi boundaries between ranks)."""
    from ..ops.triangular import GridLowerSweep, GridUpperSweep

    A = getattr(A, "_local", A)
    sweep = (GridLowerSweep if lower else GridUpperSweep)(
        A.coeffs2d, A.row_offsets, A.col_offsets, omega=omega_diag)
    M, ny = A.grid

    def update(r):
        if r.ndim == 2 and tuple(r.shape) == (M, ny):
            return sweep(r)
        if r.ndim == 2:  # multi-RHS (N, k): the columns are swept as one batch
            k = r.shape[1]
            return sweep(r.T.reshape(k, M, ny)).reshape(k, M * ny).T
        return sweep(r.reshape(M, ny)).reshape(r.shape)

    return update


def _ssor_parts(A, omega, device):
    """``(fwd, bwd, D)`` of the SSOR splitting on ``device``: the solves
    with ``D/omega + L`` and ``D/omega + U`` and the diagonal, by the three
    sweep routes."""
    if _is_grid_stencil(A):
        return (_grid_sweep_update(A, omega, True), _grid_sweep_update(A, omega, False),
                _diagonal(A, device))
    sp = _sparse_for_levels(A)
    if sp is not None:
        return (_level_solve(sp, True, device, diag_scale=omega),
                _level_solve(sp, False, device, diag_scale=omega),
                torch.as_tensor(sp.diagonal(), device=device))
    Ad = _dense_matrix(A, device)
    d = torch.diagonal(Ad)
    A_ = Ad.clone()
    torch.diagonal(A_).copy_(d / omega)
    return (lambda y: _tri_solve(A_, y, lower=True), lambda y: _tri_solve(A_, y, lower=False),
            d.clone())


def _tri_solve(Ad, y, lower):
    """Dense triangular solve of a vector or an ``(N, k)`` block, in the
    promoted type."""
    dt = torch.promote_types(Ad.dtype, y.dtype)
    y2 = y.to(dt).reshape(y.shape[0], -1)
    return torch.linalg.solve_triangular(Ad.to(dt), y2, upper=not lower).reshape(y.shape)


def gauss_seidel(A, *args, omega: float = 1.0, lower: bool = True, **kwargs):
    """x_{k+1} = x_k + omega * tri(A)^{-1} r."""
    if _is_grid_stencil(A):
        base = _grid_sweep_update(A, 1.0, lower)
        return _stationary(lambda r: omega * base(r), A, *args, **kwargs)
    device = _solve_device(A, args, kwargs)
    sp = _sparse_for_levels(A)
    if sp is not None:
        solve = _level_solve(sp, lower, device)
        return _stationary(lambda r: omega * solve(r), A, *args, **kwargs)
    Ad = _dense_matrix(A, device)
    return _stationary(lambda y: omega * _tri_solve(Ad, y, lower), A, *args, **kwargs)


def sor(A, *args, omega: float = 1.0, lower: bool = True, **kwargs):
    """x_{k+1} = x_k + (D/omega + L)^{-1} r."""
    if _is_grid_stencil(A):
        return _stationary(_grid_sweep_update(A, omega, lower), A, *args, **kwargs)
    device = _solve_device(A, args, kwargs)
    sp = _sparse_for_levels(A)
    if sp is not None:
        return _stationary(_level_solve(sp, lower, device, diag_scale=omega), A, *args, **kwargs)
    A_ = _dense_matrix(A, device).clone()
    torch.diagonal(A_).div_(omega)
    return _stationary(lambda y: _tri_solve(A_, y, lower), A, *args, **kwargs)


def _ssor_apply(fwd, bwd, D, omega, y):
    y = fwd(y)
    y = y * _bcast(D, y)
    y = bwd(y)
    return (2 - omega) / omega * y


def ssor(A, *args, omega: float = 1.0, **kwargs):
    """Symmetric SOR: forward sweep, diagonal scale, backward sweep.

    P = omega/(2-omega) * (D/omega + L) D^{-1} (D/omega + U)
    """
    fwd, bwd, D = _ssor_parts(A, omega, _solve_device(A, args, kwargs))
    return _stationary(lambda y: _ssor_apply(fwd, bwd, D, omega, y), A, *args, **kwargs)


class SSORSmoother:
    """One SSOR application as a preconditioner operator ``M r ~= P^{-1} r``.

    ``P = omega/(2-omega) * (D/omega + L) D^{-1} (D/omega + U)`` is SPD for
    SPD ``A``, so a valid CG/MINRES ``M`` and a left preconditioner for the
    transpose-free two-sided family (BiCGSTAB/CGS).  It reuses the sweep
    routes of :func:`ssor`: grid stencils take the grid sweeps, large
    scipy/CSR matrices the level-scheduled sweeps, small matrices dense
    triangular solves.  What it holds lies on ``A``'s device, or on
    ``device`` (the default device when None) for a matrix that carries
    none.

    ``rmatvec`` assumes a Hermitian ``A`` (then ``P`` is Hermitian); QMR
    with a non-Hermitian ``A`` should use a Jacobi/diagonal ``Ml`` instead.
    """

    def __init__(self, A, omega: float = 1.0, device=None):
        self.omega = float(omega)
        dev = _device.device_of(A)
        self._fwd, self._bwd, self._D = _ssor_parts(
            A, self.omega, _device.resolve(device) if dev is None else dev)
        self.dtype = self._D.dtype
        self.device = self._D.device

    def __matmul__(self, r):
        return _ssor_apply(self._fwd, self._bwd, self._D, self.omega, r)

    matvec = __matmul__

    def rmatvec(self, r):
        return self @ r
