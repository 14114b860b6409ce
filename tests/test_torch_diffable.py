"""``krylov_tpu_torch.diffable`` against ``krylov_tpu.diffable`` on the CPU,
and the gradients of K1 and K12 against autograd through their plain
versions.

Inputs are made with numpy from a seed and handed to both packages; the
reference's operators come across with ``convert.from_reference``.  All
solves run in float64 (but the float32 PET case) to ``tol`` 1e-12 or
tighter, so the two packages' gradients agree to rtol 1e-8: they run the
same recurrences, and differ only by rounding amplified by the small
systems' condition numbers (below 100).  Central differences use a step of
1e-6 (errors of order 1e-10 relative, held to 2e-4 as the reference's own
tests hold theirs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu
import krylov_tpu_torch as kt
from krylov_tpu import diffable as jdiffable
from krylov_tpu._operators import DiagonalOperator as JDiag
from krylov_tpu._operators import MatrixOperator as JMat
from krylov_tpu._operators import Product as JProduct
from krylov_tpu.ops import stencil as jst
from krylov_tpu_torch import convert, diffable
from krylov_tpu_torch._operators import tree_flatten
from krylov_tpu_torch.ops import cuda_bsr, cuda_stencil
from krylov_tpu_torch.ops import stencil as st

kt.set_default_device("cpu")

RTOL = 1e-8  # port against reference, float64 solves to 1e-12


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _spd(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, n))
    return q @ q.T + n * np.eye(n)


# ---------------------------------------------------------------------------
# the five cases of tests/test_diffable.py


def test_grad_wrt_rhs_matches_adjoint_solve():
    rng = np.random.default_rng(0)
    n = 24
    Ad = _spd(n, 0)
    b, g_out = rng.standard_normal(n), rng.standard_normal(n)

    def ref_loss(b):
        x = jdiffable.solve(JMat(jnp.asarray(Ad)), b, tol=1e-12, maxiter=200)
        return jnp.dot(jnp.asarray(g_out), x)

    want_ref = np.asarray(jax.grad(ref_loss)(jnp.asarray(b)))
    bt = _t(b, True)
    x = diffable.solve(kt.MatrixOperator(_t(Ad)), bt, tol=1e-12, maxiter=200)
    (x @ _t(g_out)).backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.linalg.solve(Ad.T, g_out),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(bt.grad.numpy(), want_ref, rtol=RTOL, atol=1e-12)


def _stencil_loss(c2, b, offsets, ny, solve, lib):
    """``sum(x**3)`` of the explicitly parameterized stencil solve."""
    def make(c):
        return lib.GridStencilOperator(c, offsets, ny, hermitian=True)

    x = solve(make(c2), b, params=(c2,), make_op=make, tol=1e-13, maxiter=400)
    return (x ** 3).sum()


def test_grad_wrt_stencil_coefficients_fd():
    A0 = jst.poisson_2d(4, 8)
    offsets, ny = A0.offsets, A0.ny
    b = np.random.default_rng(1).standard_normal(32)
    c0 = np.asarray(A0.coeffs2d)

    want = np.asarray(jax.grad(lambda c: _stencil_loss(
        c, jnp.asarray(b), offsets, ny, jdiffable.solve, jst))(jnp.asarray(c0)))
    ct = _t(c0, True)
    _stencil_loss(ct, _t(b), offsets, ny, diffable.solve, st).backward()
    got = ct.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)

    def loss(c):
        with torch.no_grad():
            return float(_stencil_loss(_t(c), _t(b), offsets, ny, diffable.solve, st))

    eps = 1e-6
    for d, i, j in [(2, 1, 3), (0, 2, 5), (4, 0, 0)]:
        cp, cm = c0.copy(), c0.copy()
        cp[d, i, j] += eps
        cm[d, i, j] -= eps
        fd = (loss(cp) - loss(cm)) / (2 * eps)
        np.testing.assert_allclose(got[d, i, j], fd, rtol=2e-4, atol=1e-7)


def _nonsymmetric():
    rng = np.random.default_rng(2)
    n = 16
    Ad = np.diag(np.linspace(2.0, 10.0, n)) + 0.3 * rng.standard_normal((n, n))
    return JMat(jnp.asarray(Ad)), rng.standard_normal(n)


def test_grad_nonsymmetric_uses_adjoint():
    op, b, _, want = _reference_grads("MatrixOperator")
    Ad = np.asarray(op.a)

    def loss(b):
        x = diffable.solve(kt.MatrixOperator(_t(Ad)), b, solver=kt.gmres, tol=1e-12,
                           maxiter=64)
        return torch.sin(x).sum()

    bt = _t(b, True)
    loss(bt).backward()
    got = bt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    eps = 1e-6
    for i in [0, 7, 15]:
        bp, bm = b.copy(), b.copy()
        bp[i] += eps
        bm[i] -= eps
        with torch.no_grad():
            fd = (float(loss(_t(bp))) - float(loss(_t(bm)))) / (2 * eps)
        np.testing.assert_allclose(got[i], fd, rtol=5e-5, atol=1e-8)


def _pet_problem():
    n = 96
    sp = scipy.sparse.diags([-1.0, 3.0, -0.5], [-1, 0, 1], shape=(n, n),
                            format="csr").astype(np.float32)  # nonsymmetric
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    g_out = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    return sp, b, g_out


@functools.cache
def _pet_reference_grad():
    """The reference's gradient through its lazy PETOperator (its Pallas
    kernel in interpret mode), computed once."""
    from krylov_tpu.ops.pallas_spmv import PETOperator as JPET

    sp, b, g_out = _pet_problem()
    A = JPET.from_scipy(sp, with_rmatvec="lazy", interpret=True)

    def loss(b):
        x = jdiffable.solve(A, b, solver=krylov_tpu.gmres, tol=1e-6, maxiter=96,
                            adjoint_solver=krylov_tpu.gmres)
        return jnp.dot(jnp.asarray(g_out), x)

    return np.asarray(jax.grad(loss)(jnp.asarray(b)))


def test_grad_through_lazy_pet_operator():
    """The lazy adjoint is built before flattening (the backward pass
    applies rmatvec on the rebuilt operator), and the PET leaves are format
    arrays: they get no gradient, b does."""
    from krylov_tpu_torch.ops.cuda_spmv import PETOperator

    sp, b, g_out = _pet_problem()
    A = PETOperator.from_scipy(sp, with_rmatvec="lazy", device="cpu")
    assert A._csr_t is None
    A._csr.data.requires_grad_()
    bt = _t(b, True)
    x = diffable.solve(A, bt, solver=kt.gmres, tol=1e-6, maxiter=96,
                       adjoint_solver=kt.gmres)
    assert A._csr_t is not None
    (x @ _t(g_out)).backward()
    assert A._csr.data.grad is None
    want = np.linalg.solve(sp.toarray().T.astype(np.float64), g_out)
    np.testing.assert_allclose(bt.grad.numpy(), want, atol=2e-3)
    np.testing.assert_allclose(bt.grad.numpy(), _pet_reference_grad(), atol=2e-3)


def test_while_loop_backend_and_grid_shaped_b():
    """In place of the reference's ``test_diffable_inside_jit``: the
    default ``while_loop`` backend with grid-shaped vectors (a
    full-contraction inner) against the reference's jitted value and grad."""
    A0 = jst.poisson_2d(4, 8)
    b = np.random.default_rng(3).standard_normal((4, 8))

    def jinner(u, v):
        return jnp.sum(jnp.conj(u) * v)

    @jax.jit
    def ref(b):
        return jax.value_and_grad(lambda b: jnp.sum(jdiffable.solve(
            A0, b, tol=1e-12, maxiter=200, inner=jinner) ** 2))(b)

    v_ref, g_ref = ref(jnp.asarray(b))
    A = convert.from_reference(A0, device="cpu")
    bt = _t(b, True)
    v = (diffable.solve(A, bt, tol=1e-12, maxiter=200,
                        inner=lambda u, w: torch.sum(u.conj() * w)) ** 2).sum()
    v.backward()
    assert bt.grad.shape == (4, 8) and bool(torch.isfinite(bt.grad).all())
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=RTOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_ref), rtol=RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# default leaves: every leaf of the operator is a parameter


def _bsr_pair():
    """An SPD matrix of 8 x 8 blocks on a random block pattern, as the
    reference's BSROperator."""
    from krylov_tpu.ops.bsr import BSROperator as JBSR

    rng = np.random.default_rng(12)
    nb, R = 4, 8
    blocks = scipy.sparse.random(nb, nb, density=0.4, random_state=3, format="csr")
    pattern = np.kron((blocks + blocks.T).toarray() != 0, np.ones((R, R)))
    half = pattern * rng.standard_normal((nb * R,) * 2)
    dense = half + half.T + 4 * nb * R ** 0.5 * np.eye(nb * R)
    return JBSR.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(R, R))


def _csr_pair():
    """A random sparse SPD matrix as the reference's CSROperator."""
    from krylov_tpu.ops.sparse import CSROperator as JCSR

    n = 30
    sp = scipy.sparse.random(n, n, density=0.15, random_state=4, format="csr")
    return JCSR.from_scipy((sp + sp.T + 5 * scipy.sparse.eye(n)).tocsr())


def _with_rhs(op):
    return op, np.random.default_rng(9).standard_normal(op.shape[0])


# kind: (the reference's operator and b, solver, maxiter)
DEFAULT_LEAF_CASES = {
    "MatrixOperator": (_nonsymmetric, "gmres", 64),
    "GridStencilOperator": (lambda: _with_rhs(jst.diffusion_2d(
        np.exp(np.random.default_rng(8).standard_normal((6, 7))))), "cg", 42),
    "CSROperator": (lambda: _with_rhs(_csr_pair()), "cg", 30),
    "BSROperator": (lambda: _with_rhs(_bsr_pair()), "cg", 32),
}


@functools.cache
def _reference_grads(kind):
    """The reference operator, b, the float leaves of the reference's
    gradient pytree and its gradient in b, for ``sum(sin(x))``; once per
    case (the reference compiles its while_loop solve and adjoint)."""
    make, solver, maxiter = DEFAULT_LEAF_CASES[kind]
    op, b = make()

    def loss(op, b):
        x = jdiffable.solve(op, b, solver=getattr(krylov_tpu, solver), tol=1e-12,
                            maxiter=maxiter)
        return jnp.sum(jnp.sin(x))

    g_op, g_b = jax.grad(loss, argnums=(0, 1), allow_int=True)(op, jnp.asarray(b))
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(g_op)
              if jnp.issubdtype(leaf.dtype, jnp.inexact)]
    return op, b, leaves, np.asarray(g_b)


@pytest.mark.parametrize("kind", sorted(DEFAULT_LEAF_CASES))
def test_default_leaves_match_reference_gradient(kind):
    ref_op, b, want, _ = _reference_grads(kind)
    _, solver, maxiter = DEFAULT_LEAF_CASES[kind]
    op = convert.from_reference(ref_op, device="cpu")
    leaves = [leaf for leaf in tree_flatten(op)[0] if leaf.is_floating_point()]
    assert len(leaves) == len(want) >= 1
    for leaf in leaves:
        leaf.requires_grad_()
    x = diffable.solve(op, _t(b), solver=getattr(kt, solver), tol=1e-12, maxiter=maxiter)
    torch.sin(x).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=RTOL, atol=1e-12)


def test_default_leaves_of_a_product():
    """A ``Product(DiagonalOperator(d), MatrixOperator(a))``: its leaves,
    in the reference's order, each get the gradient the reference's own
    pytree gives (``jax.grad`` through a dense solve of the reference
    product: its ``Product`` has no shape or adjoint for a Krylov solve)."""
    rng = np.random.default_rng(10)
    n = 12
    d0, a0 = 1.0 + rng.random(n), _spd(n, 11)
    b = rng.standard_normal(n)
    ref = JProduct(JDiag(jnp.asarray(d0)), JMat(jnp.asarray(a0)))

    def ref_loss(P):
        dd, aa = P.operators[0].d, P.operators[1].a
        return jnp.sum(jnp.sin(jnp.linalg.solve(dd[:, None] * aa, jnp.asarray(b))))

    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jax.grad(ref_loss)(ref))]
    P = convert.from_reference(ref, device="cpu")
    assert isinstance(P, kt.Product) and P.shape == (n, n)
    leaves = tree_flatten(P)[0]
    assert [tuple(t.shape) for t in leaves] == [(n,), (n, n)]
    for leaf in leaves:
        leaf.requires_grad_()
    x = diffable.solve(P, _t(b), solver=kt.gmres, tol=1e-13, maxiter=n)
    torch.sin(x).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-7, atol=1e-12)


def test_tree_flatten_keeps_the_reference_order():
    """Children in the reference's order, rebuilt whole: a stencil's
    ``row_col_offsets``, a const stencil's weights and a CSR matrix's
    ``row_ids`` survive the round trip."""
    from krylov_tpu_torch._operators import tree_unflatten

    A = st.diffusion_2d(np.ones((5, 6)), device="cpu")
    G = st.GridStencilOperator(A.coeffs2d, None, 6,
                               row_col_offsets=((0, 1), (-2, 2)))
    C = kt.poisson_2d_const(5, 6, device="cpu")
    csr = convert.from_reference(_csr_pair(), device="cpu")
    cheb = kt.ChebyshevPreconditioner(A, (0.5, 8.0), degree=3)
    op = kt.Product(kt.Identity(), cheb, G, C, csr)
    leaves, treedef = tree_flatten(op)
    want = [A.coeffs2d, A.coeffs2d, csr.data, csr.indices, csr.indptr, csr.row_ids]
    assert len(leaves) == len(want) and all(a is b for a, b in zip(leaves, want))
    back = tree_unflatten(treedef, leaves)
    G2, C2 = back.operators[2], back.operators[3]
    assert (G2.row_offsets, G2.col_offsets) == ((0, 1), (-2, 2))
    assert C2.weights == C.weights and C2.kernel_bands == C.kernel_bands
    assert back.operators[1].degree == 3 and back.operators[4].row_ids is csr.row_ids
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(30))
    torch.testing.assert_close(back @ x, op @ x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, leaves + [leaves[0]])


def test_from_reference_product_and_identity():
    d = np.arange(1.0, 5.0)
    P = convert.from_reference(JProduct(krylov_tpu.Identity(), JDiag(jnp.asarray(d))),
                               device="cpu")
    assert isinstance(P.operators[0], kt.Identity)
    np.testing.assert_array_equal(P.operators[1].d.numpy(), d)
    np.testing.assert_array_equal((P @ torch.ones(4, dtype=torch.float64)).numpy(), d)


# ---------------------------------------------------------------------------
# gradcheck, the kernels' Functions, complex operators, unconverged solves


def test_gradcheck_on_b_and_coefficients():
    """float64 gradcheck of the solve in ``b`` and in the coefficient
    planes; gmres and no Hermitian flag, so every perturbed operator is
    solved exactly and the adjoint solve runs on ``A^H``."""
    A0 = st.diffusion_2d(np.exp(np.random.default_rng(14).standard_normal((3, 4))),
                         device="cpu")
    ro, co = A0.row_offsets, A0.col_offsets

    def make(c):
        return st.GridStencilOperator(c, None, 4, row_col_offsets=(ro, co))

    def f(b, c):
        return diffable.solve(make(c), b, params=(c,), make_op=make, solver=kt.gmres,
                              tol=1e-14, atol=0.0, maxiter=12)

    b = torch.from_numpy(np.random.default_rng(15).standard_normal(12)).requires_grad_()
    c = A0.coeffs2d.clone().requires_grad_()
    assert torch.autograd.gradcheck(f, (b, c), eps=1e-6, atol=1e-7, rtol=1e-5)


K1_CASES = [(torch.float64, torch.float64, False, False),
            (torch.float64, torch.float64, True, False),
            (torch.float64, torch.float64, False, True),
            (torch.complex128, torch.complex128, False, False),
            (torch.float64, torch.complex128, False, False),
            (torch.float32, torch.float32, False, False)]


@pytest.mark.parametrize("cdt,xdt,batched,halos", K1_CASES)
def test_k1_backward_equals_autograd_through_plain(cdt, xdt, batched, halos):
    """The Function's backward (coefficients in plain torch, x by K1's
    adjoint stencil, halos) against autograd through the plain version, on
    a 9-point stencil with a two-row band, at 1e-12 (1e-5 in float32) of
    the largest entry."""
    rng = np.random.default_rng(16)
    ro, co = (-2, -1, -1, 0, 0, 0, 1, 1, 2), (0, -1, 1, -1, 0, 1, 0, 2, -1)
    M, ny = 7, 9

    def rand(shape, dt):
        t = torch.from_numpy(rng.standard_normal(shape))
        if dt.is_complex:
            t = torch.complex(t, torch.from_numpy(rng.standard_normal(shape)))
        return t.to(dt)

    c = rand((len(ro), M, ny), cdt)
    x = rand((3, M, ny) if batched else (M, ny), xdt)
    top, bot = (rand((2, ny), xdt), rand((2, ny), xdt)) if halos else (None, None)
    out_dt = torch.promote_types(cdt, xdt)
    w = rand(tuple(x.shape), out_dt)
    inputs = [t for t in (c, x, top, bot) if t is not None]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        args = leaves + [None] * (4 - len(leaves))
        y = fn(args[0], args[1], ro, co, args[2], args[3])
        (y * w.conj()).real.sum().backward()
        return [t.grad for t in leaves]

    tol = 1e-5 if cdt == torch.float32 else 1e-12
    for got, want in zip(grads(cuda_stencil.stencil2d_matvec),
                         grads(cuda_stencil.stencil2d_matvec_plain)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


def test_k1_gradcheck_and_grid_operator():
    """gradcheck of K1 in both arguments; a ``GridStencilOperator`` matvec
    carries its coefficients' gradient (flat, grid and multi-RHS vectors)."""
    A = st.diffusion_2d(np.exp(np.random.default_rng(17).standard_normal((4, 5))),
                        device="cpu")
    c = A.coeffs2d.clone().requires_grad_()
    x = torch.from_numpy(np.random.default_rng(18).standard_normal((4, 5))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda c, x: cuda_stencil.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets), (c, x))
    G = st.GridStencilOperator(c, A.offsets, 5, hermitian=True)
    v = x.detach()
    for vec, grid in ((v.reshape(-1), v), (v, v),
                      (v.reshape(20, 1).repeat(1, 2), v.expand(2, 4, 5))):
        (G @ vec).sum().backward()
        want = torch.autograd.grad(cuda_stencil.stencil2d_matvec_plain(
            c, grid, A.row_offsets, A.col_offsets).sum(), c)[0]
        torch.testing.assert_close(c.grad, want, rtol=0, atol=1e-12)
        c.grad = None
    with pytest.raises(TypeError, match="out= takes no gradient"):
        cuda_stencil.stencil2d_matvec(c, x, A.row_offsets, A.col_offsets,
                                      out=torch.empty(4, 5, dtype=torch.float64))


@pytest.mark.parametrize("dt", [torch.float64, torch.complex128])
def test_k12_backward_equals_autograd_through_plain(dt):
    """The Function's data and X gradients against autograd through the
    plain version (rectangular 6 x 4 blocks, two block slots a row, k = 3),
    and gradcheck."""
    rng = np.random.default_rng(19)
    nbrows, max_blocks, R, C, nbcols, k = 5, 2, 6, 4, 3, 3

    def rand(shape):
        t = torch.from_numpy(rng.standard_normal(shape))
        return torch.complex(t, torch.from_numpy(rng.standard_normal(shape))).to(dt) \
            if dt.is_complex else t.to(dt)

    data = rand((nbrows * max_blocks, R, C))
    cols = torch.from_numpy(rng.integers(0, nbcols, (nbrows, max_blocks)).astype(np.int32))
    x = rand((nbcols * C, k))
    w = rand((nbrows * R, k))

    def grads(fn):
        d, xx = data.clone().requires_grad_(), x.clone().requires_grad_()
        (fn(d, cols, xx) * w.conj()).real.sum().backward()
        return d.grad, xx.grad

    for got, want in zip(grads(cuda_bsr.bsr_spmm), grads(cuda_bsr.bsr_spmm_plain)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))
    assert torch.autograd.gradcheck(
        lambda d, xx: cuda_bsr.bsr_spmm(d, cols, xx),
        (data.clone().requires_grad_(), x.clone().requires_grad_()))


def _hpd(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return q @ q.conj().T + n * np.eye(n)


def _complex_problem():
    rng = np.random.default_rng(20)
    n = 8
    A = _hpd(n, 21)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b, w


def _jax_true_grad(A, b, w):
    """``jax.grad`` of ``Re vdot(w, x)`` through ``jnp.linalg.solve``."""
    return np.asarray(jax.grad(lambda b: jnp.real(jnp.vdot(
        jnp.asarray(w), jnp.linalg.solve(jnp.asarray(A), b))))(jnp.asarray(b)))


def test_complex_gradient_is_pytorchs_convention():
    """On a complex Hermitian positive definite operator the port's
    gradient is the true one under PyTorch's convention: the conjugate of
    ``jax.grad`` through a dense solve, and ``dL/dRe b + i dL/dIm b`` by
    central differences."""
    A, b, w = _complex_problem()

    def loss(b):
        x = diffable.solve(kt.MatrixOperator(_t(A)), b, tol=1e-13, maxiter=40)
        return torch.real(torch.vdot(_t(w), x))

    bt = _t(b, True)
    loss(bt).backward()
    got = bt.grad.numpy()
    np.testing.assert_allclose(got, np.conj(_jax_true_grad(A, b, w)), rtol=1e-9, atol=1e-12)
    eps = 1e-6
    for i in range(len(b)):
        fd = []
        for step in (eps, 1j * eps):
            bp, bm = b.copy(), b.copy()
            bp[i] += step
            bm[i] -= step
            with torch.no_grad():
                fd.append((float(loss(_t(bp))) - float(loss(_t(bm)))) / (2 * eps))
        np.testing.assert_allclose(got[i], fd[0] + 1j * fd[1], rtol=1e-6, atol=1e-9)


def test_reference_complex_gradient_fault():
    """Queue 3, reference fault: ``krylov_tpu.diffable`` solves
    ``A^H lambda = g`` with JAX's cotangent ``g``, whose exact adjoint is
    ``A^{-T}``; on a complex operator its gradient leaves ``jax.grad``
    through a dense solve (by about 0.1 here), while the port's formula is
    exact under PyTorch's convention (the test above)."""
    A, b, w = _complex_problem()
    ref = np.asarray(jax.grad(lambda b: jnp.real(jnp.vdot(jnp.asarray(w), jdiffable.solve(
        JMat(jnp.asarray(A)), b, tol=1e-13, maxiter=40))))(jnp.asarray(b)))
    true = _jax_true_grad(A, b, w)
    assert np.abs(ref - true).max() > 1e-2
    # JAX's cotangent of x is conj(w): the reference returns A^{-H} conj(w),
    # the true gradient is A^{-T} conj(w)
    np.testing.assert_allclose(ref, np.linalg.solve(A.conj().T, w.conj()), rtol=1e-9)
    np.testing.assert_allclose(true, np.linalg.solve(A.T, w.conj()), rtol=1e-9)


def test_unconverged_solve_returns_last_iterate():
    """An unconverged solve degrades to its last iterate (``info.xk``) in
    both passes instead of failing."""
    A = st.poisson_2d(6, 7, device="cpu")
    b = torch.from_numpy(np.random.default_rng(22).standard_normal(42)).requires_grad_()
    _, info = kt.cg(A, b.detach(), tol=1e-30, maxiter=3, backend="while_loop")
    assert not info.success
    x = diffable.solve(A, b, tol=1e-30, maxiter=3)
    torch.testing.assert_close(x.detach(), info.xk, rtol=0, atol=0)
    x.sum().backward()
    _, adj = kt.cg(A, torch.ones(42, dtype=torch.float64), tol=1e-30, maxiter=3,
                   backend="while_loop")
    torch.testing.assert_close(b.grad, adj.xk, rtol=0, atol=0)


def test_solution_never_aliases_an_input():
    """A solve that returns ``x0`` itself (already converged) hands back a
    copy, so autograd's saved solution is not the caller's buffer."""
    A = kt.MatrixOperator(torch.eye(5, dtype=torch.float64))
    b = torch.ones(5, dtype=torch.float64, requires_grad=True)
    x0 = torch.ones(5, dtype=torch.float64)

    def returns_x0(A, b, x0=None, **kw):
        return x0, kt.Info(True, x0, 0, np.zeros(1))

    x = diffable.solve(A, b, solver=returns_x0, x0=x0)
    assert x.untyped_storage().data_ptr() != x0.untyped_storage().data_ptr()
    x0.add_(1.0)
    x.sum().backward()
    torch.testing.assert_close(b.grad, torch.ones(5, dtype=torch.float64) + 1.0)


def test_parameter_vjp_asks_no_gradient_of_x(monkeypatch):
    """The backward's parameter VJP differentiates ``make_op(*p) @ x`` in the
    parameters only: K1's ``x`` gradient (the adjoint stencil) is never
    built, as K12's, which the card refuses, is never asked for."""
    def refuse(*args, **kwargs):
        raise AssertionError("the VJP asked for a gradient to x")

    monkeypatch.setattr(cuda_stencil, "stencil2d_adjoint_planes", refuse)
    A = st.diffusion_2d(np.exp(np.random.default_rng(23).standard_normal((5, 6))),
                        device="cpu")
    A.coeffs2d.requires_grad_()
    x = diffable.solve(A, torch.ones(30, dtype=torch.float64), tol=1e-12)
    x.sum().backward()
    assert A.coeffs2d.grad is not None and bool(torch.isfinite(A.coeffs2d.grad).all())


def test_backward_imports_no_sympy():
    """The backward takes the parameter VJP as the gradient of a scalar:
    ``torch.autograd.grad`` with a tensor ``grad_outputs`` imports sympy
    for its shape check (1.2 s on a CPU host, ~4 s on the H100 machine's
    host, at a process's first backward), in a fresh interpreter."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np, torch, krylov_tpu_torch as kt; "
        "kt.set_default_device('cpu'); "
        "A = kt.ops.diffusion_2d(np.ones((8, 8))); A.coeffs2d.requires_grad_(); "
        "b = torch.ones(64, dtype=torch.float64, requires_grad=True); "
        "kt.diffable.solve(A, b, tol=1e-10).sum().backward(); "
        "assert A.coeffs2d.grad is not None and b.grad is not None; "
        "sys.exit(1 if 'sympy' in sys.modules else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
