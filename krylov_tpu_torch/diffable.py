"""Differentiable linear solves (implicit function theorem).

Counterpart of ``krylov_tpu.diffable``: gradients flow *through* a Krylov
solve without differentiating the iteration.  For
``x(theta) = A(theta)^{-1} b(theta)``:

    dL/db     = lambda,                 where  A^H lambda = dL/dx
    dL/dtheta = -Re <lambda, dA/dtheta x>   (via a VJP of the matvec)

so the backward pass is one adjoint solve with the same solver: O(1)
memory in the iteration count.  The solve is a ``torch.autograd.Function``
whose inputs are ``b`` and the parameters; the parameter VJP is autograd
through ``make_op(*params) @ x``, which reaches the operators' kernels
through their own gradients (K1's and K12's,
:mod:`krylov_tpu_torch.ops.cuda_stencil`, :mod:`krylov_tpu_torch.ops.cuda_bsr`).

PyTorch's gradient of a real loss in a complex tensor is the conjugate of
JAX's, so the formula above is exact here for complex operators as well
(the reference solves ``A^H lambda = g`` with JAX's cotangent ``g``, for
which the exact adjoint is ``A^{-T}``: its complex gradients differ).

Usage::

    from krylov_tpu_torch import diffable

    coeffs2d.requires_grad_()
    A = GridStencilOperator(coeffs2d, offsets, ny, hermitian=True)
    x = diffable.solve(A, b)          # the operator's leaves are the parameters
    (x ** 2).sum().backward()         # coeffs2d.grad, and b.grad if b requires it

or, with an explicit parameterization ``A = make_op(*params)``,
``diffable.solve(A, b, params=(c,), make_op=lambda c: ...)``.
"""

import torch
from torch.autograd.function import once_differentiable

from . import _device
from ._operators import as_operator, tree_flatten, tree_unflatten
from .ops.cuda_stencil import _as_grad
from .solvers.cg import cg


class _Adjoint:
    """``A^H`` for the adjoint solve of an operator not flagged Hermitian:
    the matvec is ``A.rmatvec``, with what the solvers' set-up reads
    (shape, dtype, device, vector shape)."""

    def __init__(self, A):
        self._A = A
        self.shape = A.shape
        self.dtype = getattr(A, "dtype", None)
        self.device = _device.device_of(A)
        self.vector_shape = getattr(A, "vector_shape", None)

    def __matmul__(self, v):
        return self._A.rmatvec(v)

    matvec = __matmul__

    def rmatvec(self, v):
        return self._A @ v


class _Spec:
    """What the solve's forward and backward share besides tensors."""

    def __init__(self, make_op, solver, adjoint_solver, kwargs, params_differentiable):
        self.make_op = make_op
        self.solver = solver
        self.adjoint_solver = adjoint_solver
        self.kwargs = kwargs
        self.params_differentiable = params_differentiable


def _shares_storage(a, b):
    return (isinstance(b, torch.Tensor)
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, b, *params):
        # info.xk rather than the sol-or-None first element: an unconverged
        # solve degrades to its last iterate instead of failing
        _, info = spec.solver(spec.make_op(*params), b, **spec.kwargs)
        x = info.xk
        if any(_shares_storage(x, t) for t in (b, spec.kwargs.get("x0"), *params)):
            x = x.clone()  # x is saved: it must not be an input's buffer
        ctx.spec = spec
        ctx.b_like = torch.empty(0, dtype=b.dtype)
        ctx.others = [None if isinstance(p, torch.Tensor) else p for p in params]
        ctx.save_for_backward(x, *(p if isinstance(p, torch.Tensor) else None
                                   for p in params))
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec = ctx.spec
        x, *saved = ctx.saved_tensors
        x = x.detach()  # the saved output carries this node: no gradient to it
        params = [t if o is None else o for t, o in zip(saved, ctx.others)]
        A = as_operator(spec.make_op(*params), x.device)
        # the adjoint system A^H lambda = g, with the forward's arguments;
        # its matvec is A.rmatvec, whose copy is built before the solve
        hermitian = getattr(A, "hermitian", False)
        if not hermitian and hasattr(A, "ensure_adjoint"):
            A.ensure_adjoint()
        A_adj = A if hermitian else _Adjoint(A)
        _, info = spec.adjoint_solver(A_adj, g, **spec.kwargs)
        lam = info.xk
        grads = [None] * len(params)
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        if spec.params_differentiable and wanted:
            # d/dparams: the VJP of params -> make_op(*params) @ x at -lambda,
            # on fresh leaves, as the gradient of the real scalar
            # Re <-lambda, y> (its gradient in y is -lambda): autograd.grad
            # with a tensor grad_outputs imports sympy for its shape check,
            # seconds at a process's first backward
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(i in wanted)
                          if isinstance(p, torch.Tensor) else p
                          for i, p in enumerate(params)]
                y = spec.make_op(*leaves) @ x
                v = _as_grad(-lam, y)
                s = (y * v.conj()).real.sum() if y.is_complex() else (y * v).sum()
                got = torch.autograd.grad(s, [leaves[i] for i in wanted], allow_unused=True)
            for i, gi in zip(wanted, got):
                grads[i] = gi
        d_b = _as_grad(lam, ctx.b_like) if ctx.needs_input_grad[1] else None
        return (None, d_b, *grads)


def solve(A, b, params=None, make_op=None, solver=cg, adjoint_solver=None,
          **solver_kwargs):
    """Solve ``A x = b`` with gradients defined by the implicit function
    theorem; returns ``x`` only (use the plain solver for ``Info``).

    * ``A``: an operator (its leaves, :func:`~krylov_tpu_torch._operators.
      tree_flatten`, are differentiated when ``params``/``make_op`` are
      omitted; a lazy adjoint is built first, and an operator with
      ``params_differentiable = False`` gives gradients through ``b``
      only).
    * ``params``/``make_op``: an explicit parameterization ``A =
      make_op(*params)``; gradients are returned for ``params``.
    * ``solver``: any solver of the package; ``adjoint_solver`` (default
      the same) solves ``A^H lambda = dL/dx``, with ``A`` itself when its
      ``hermitian`` flag is set.  Both get ``solver_kwargs`` (``x0``
      included), with ``backend="while_loop"`` by default.
    """
    params_differentiable = True
    if params is None or make_op is None:
        if hasattr(A, "ensure_adjoint"):
            # the backward pass applies rmatvec on the RECONSTRUCTED
            # operator: a lazy adjoint is built before flattening drops
            # its host handle
            A.ensure_adjoint()
        params_differentiable = getattr(A, "params_differentiable", True)
        params, treedef = tree_flatten(A)

        def make_op(*leaves):
            return tree_unflatten(treedef, leaves)

    kwargs = dict(solver_kwargs)
    kwargs.setdefault("backend", "while_loop")
    spec = _Spec(make_op, solver, solver if adjoint_solver is None else adjoint_solver,
                 kwargs, params_differentiable)
    b = _device.as_tensor(b, _device.device_of(A))
    return _Solve.apply(spec, b, *params)
