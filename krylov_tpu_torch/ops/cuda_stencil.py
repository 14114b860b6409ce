"""Grid-stencil kernels: CUDA wrappers, their plain PyTorch versions and
launch counters.

Counterpart of ``krylov_tpu.ops.pallas_stencil`` (sources in
``krylov_tpu_torch/csrc/stencil.cu``):

* K1 :func:`stencil2d_matvec` — ``y[i,j] = sum_d c[d,i,j] * x[i+dr_d, j+dc_d]``,
* K2 :func:`const_stencil2d_matvec` — the same with scalar weights and
  in-kernel Dirichlet masks (real weights; real or complex vectors),
* K3 :func:`cg_fused_phase_a` — ``p = r + omega p``, ``Ap`` (const), ``<p, Ap>``,
* K5 :func:`cg_fused_phase_a_var` — K3 with coefficient planes,
* K6 :func:`cg_fused_phase_a_var_jac` — K5 with ``p = dinv r + omega p``,
* K4 :func:`cg_fused_phase_b` — ``y += alpha p``, ``r -= alpha Ap``, ``<r, r>``,
* K7 :func:`cg_fused_phase_b_jac` — K4 with ``<r, dinv r>``,
* K8 :func:`jacobi_sweep_const` — ``z + w (r - A z)`` or ``r - A z`` (const),
* K9 :func:`jacobi_sweep_var` — K8 with coefficient planes and a weight plane.

K1, K2, K8 and K9 take complex64 and complex128 vectors as well as real
ones, as the reference computes them (its ``supports()`` sends complex
vectors to the XLA forms): K2 and K8 with their real scalar weights, K1 and
K9 with planes that are real or of the vector's type.

A wrapper runs its plain version only when its tensors lie on the CPU; on
a CUDA device it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``; the plain versions count nothing.  A launch captured into the
``while_loop`` driver's CUDA graph counts once for each step that a replay
runs (:func:`krylov_tpu_torch._graphs.count`).

Gradients: K1 is a ``torch.autograd.Function`` on both devices (its
backward is plain torch for the coefficients and K1 itself, the adjoint
stencil, for ``x``), so a solve's parameter gradient reaches it
(:mod:`krylov_tpu_torch.diffable`).  Every other kernel has no backward: on
the card its wrapper raises a ``TypeError`` when grad mode is on and an
input requires a gradient, so no launch drops a gradient silently; on the
CPU autograd differentiates the plain version.

Const bands are the reference's ``(dr, dc, weight, row_constraints)``
tuples (``ConstStencilOperator.bands``): band d is valid on global row g
iff ``0 <= (g // stride) % size + step < size`` for each ``(stride, size,
step)`` of its constraints, and at column j iff ``0 <= j + dc < ny``.  K2,
K3 and K8 and their plain versions sum the bands in ascending ``(dr, dc)``
order, the order of the variable-coefficient operator's bands, and not in
the order they are listed: the reference's Laplacians list the centre
first, and ``4x - x - x - x - x`` summed from the centre rounds at four
times the neighbours' magnitude.  Measured on the CPU (poisson 512^2, f32
CG against f64 over 100 steps, b = 1): 1.2e-4 in the listed order, 2e-6 in
grid order; in grid order a const Laplacian's f32 matvec equals the
variable-coefficient one's bit for bit.

Unlike the TPU kernels, no kernel here writes into a buffer whose
neighbour rows it reads: blocks run in parallel and block i+1 reads rows
of block i.  Scalars (omega, alpha, pAp, rho) stay in 0-d device tensors.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .._graphs import count as _count

LAUNCHES = {
    "stencil2d_matvec": 0,
    "const_stencil2d_matvec": 0,
    "cg_fused_phase_a": 0,
    "cg_fused_phase_a_var": 0,
    "cg_fused_phase_a_var_jac": 0,
    "cg_fused_phase_b": 0,
    "cg_fused_phase_b_jac": 0,
    "jacobi_sweep_const": 0,
    "jacobi_sweep_var": 0,
}

# dtype codes of csrc/stencil.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
          torch.complex64: 3, torch.complex128: 4}
# (coefficient dtype, vector dtype) pairs K1 is instantiated for
_K1_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64),
    (torch.complex64, torch.complex64),
    (torch.float32, torch.complex64),
    (torch.complex128, torch.complex128),
    (torch.float64, torch.complex128),
}
# vector dtypes of K2 and of K8
_K2_TYPES = {torch.float32, torch.bfloat16, torch.float64, torch.complex64,
             torch.complex128}
_SWEEP_TYPES = {torch.float32, torch.float64, torch.complex64, torch.complex128}
# (plane dtype, vector dtype) pairs K9 is instantiated for: K1's, without bf16
_K9_PAIRS = {pair for pair in _K1_PAIRS if torch.bfloat16 not in pair}


def reset_launches():
    for counts in (LAUNCHES, K2_PATHS):
        for name in counts:
            counts[name] = 0


def halo_rows(row_offsets):
    """Rows a stencil reads above or below its own: ``max |dr|``."""
    return max(max(0, -min(row_offsets)), max(0, max(row_offsets)))


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load()
    vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    cb = [i32, vp, vp, vp, vp, vp]  # a const band set: ndiag, dr, dc, w, ncons, cons
    for name, args, res in (
        ("krylov_error_string", [i32], ctypes.c_char_p),
        ("krylov_max_bands", [], i32),
        ("krylov_max_constraints", [], i32),
        ("krylov_phase_a_partials", [i32, i32], i64),
        ("krylov_phase_b_partials", [i64], i64),
        ("krylov_stencil2d", [i32, i32] + [vp] * 5 + [i32] * 4 + [vp, vp, i32, vp], i32),
        ("krylov_k2_max_halo", [], i32),
        ("krylov_const_stencil2d", [i32, i32] + [vp] * 4 + [i32] * 5 + cb + [vp], i32),
        ("krylov_cg_phase_a_const", [vp] * 7 + [i32, i32] + cb + [vp], i32),
        ("krylov_jacobi_sweep_const", [i32, f64, vp, vp, vp, i32, i32, i32] + cb + [vp],
         i32),
        ("krylov_jacobi_sweep_var", [i32, i32] + [vp] * 5 + [i32, i32, i32, vp, vp, vp],
         i32),
        ("krylov_cg_phase_a_var", [vp] * 8 + [i32, i32, i32, vp, vp, vp], i32),
        ("krylov_cg_phase_a_var_jac", [vp] * 9 + [i32, i32, i32, vp, vp, vp], i32),
        ("krylov_cg_phase_b", [vp] * 7 + [i64, vp], i32),
        ("krylov_cg_phase_b_jac", [vp] * 8 + [i64, vp], i32),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    if lib.krylov_k2_max_halo() != K2_MAX_HALO:
        raise RuntimeError("K2_MAX_HALO differs from csrc/stencil.cu's KRYLOV_K2_MAX_HALO")
    return lib


def _check(lib, err, name):
    if err:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.krylov_error_string(err).decode()}"
        )


def _bands(lib, row_offsets, col_offsets):
    n = len(row_offsets)
    if not 1 <= n <= lib.krylov_max_bands() or len(col_offsets) != n:
        raise ValueError(f"unsupported band set {row_offsets}, {col_offsets}")
    return (ctypes.c_int * n)(*row_offsets), (ctypes.c_int * n)(*col_offsets)


def grid_order(bands):
    """Const bands in the order the kernels sum them: ascending (dr, dc)."""
    return tuple(sorted(bands, key=lambda b: (b[0], b[1])))


def _const_bands(lib, bands):
    """ctypes arrays of a const band set in summation order, laid out as
    krylov_const_stencil2d takes them (ndiag, dr, dc, w, ncons, cons)."""
    bands = grid_order(bands)
    n, maxc = len(bands), lib.krylov_max_constraints()
    if not 1 <= n <= lib.krylov_max_bands():
        raise ValueError(f"{n} bands: the kernels take 1 to {lib.krylov_max_bands()}")
    cons = [0] * (n * maxc * 3)
    for d, (_, _, _, cs) in enumerate(bands):
        if len(cs) > maxc:
            raise ValueError(f"band {d} has {len(cs)} row constraints; at most {maxc}")
        for k, triple in enumerate(cs):
            cons[(d * maxc + k) * 3:(d * maxc + k + 1) * 3] = triple
    return (
        n,
        (ctypes.c_int * n)(*(b[0] for b in bands)),
        (ctypes.c_int * n)(*(b[1] for b in bands)),
        (ctypes.c_double * n)(*(float(b[2]) for b in bands)),
        (ctypes.c_int * n)(*(len(b[3]) for b in bands)),
        (ctypes.c_int * len(cons))(*cons),
    )


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_cpu(*tensors):
    """True for CPU tensors, False for CUDA tensors on one device; raises
    on any other mix."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise NotImplementedError(f"no kernel for device {dev}")
    return False


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name, *tensors):
    """On the card: a kernel without a backward refuses inputs that want a
    gradient rather than return a result autograd cannot see through."""
    if _wants_grad(*tensors):
        raise TypeError(
            f"{name}: this CUDA kernel has no gradient; detach its inputs, or "
            "differentiate the solve with krylov_tpu_torch.diffable.solve")


def _disjoint(a, b):
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a1 <= b0 or b1 <= a0


def _grid_out(out, like, dtype, *reads):
    """``out`` checked (contiguous, ``like``'s shape, ``dtype``, disjoint
    from every tensor in ``reads``), or a new tensor when None."""
    if out is None:
        return torch.empty(like.shape, dtype=dtype, device=like.device)
    _require(out.dtype == dtype and out.shape == like.shape and out.is_contiguous(),
             f"out must be a contiguous {dtype} tensor of shape {tuple(like.shape)}")
    for t in reads:
        if t is not None:
            _require(_disjoint(out, t), "out must not overlap an input")
    return out


def _halos(top_halo, bot_halo, h, ny, dtype, batched):
    """The caller's (h, ny) halo rows, cast to the vector dtype, or None."""
    halos = []
    for halo in (top_halo, bot_halo):
        if halo is None or h == 0:
            halos.append(None)
            continue
        _require(not batched, "halos apply to a single (M, ny) grid")
        _require(tuple(halo.shape) == (h, ny), f"halo {tuple(halo.shape)} != {(h, ny)}")
        halos.append(halo.to(dtype).contiguous())
    return halos


def _x_ext(x, h_real, acc, top_halo, bot_halo):
    """``x`` in the accumulation dtype, extended by ``max(h_real, 1)`` rows
    of halo (zeros when omitted) above and below, as the reference's XLA
    forms build it."""
    h = max(h_real, 1)
    lead, ny = tuple(x.shape[:-2]), x.shape[-1]

    def edge(halo):
        if halo is None or h_real == 0:
            return torch.zeros(lead + (h, ny), dtype=acc, device=x.device)
        return halo.to(x.dtype).to(acc).expand(lead + (h, ny))

    return torch.cat([edge(top_halo), x.to(acc), edge(bot_halo)], dim=-2), h


# ---------------------------------------------------------------------------
# K1: stencil matvec
# ---------------------------------------------------------------------------


def stencil2d_matvec_plain(coeffs, x, row_offsets, col_offsets,
                           top_halo=None, bot_halo=None):
    """Plain version of K1: the padded-shift form of the reference
    ``GridStencilOperator._matvec_2d``, bands summed in the same order.

    ``x`` is ``(M, ny)`` or a ``(B, M, ny)`` batch; halos are ``(h, ny)``
    rows logically at ``x[-h:0]`` / ``x[M:M+h]`` (zeros when omitted).
    Accumulates in float32 for float32/bfloat16 inputs (float64 and complex
    in their own type) and returns ``promote_types(coeffs, x)``.
    """
    out_dtype = torch.promote_types(coeffs.dtype, x.dtype)
    acc = torch.promote_types(out_dtype, torch.float32)
    M = x.shape[-2]
    x_ext, h = _x_ext(x, halo_rows(row_offsets), acc, top_halo, bot_halo)
    y = None
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        term = coeffs[d].to(acc) * _shifted(x_ext, h, M, dr, dc)
        y = term if y is None else y + term
    return y.to(out_dtype)


def _shifted(x_ext, h, M, dr, dc):
    """``x_ext[h + dr + i, j + dc]`` on the ``(M, ny)`` grid, zero where the
    column leaves it (the padded-shift read of the plain version)."""
    seg = x_ext[..., h + dr : h + dr + M, :]
    if dc > 0:
        seg = F.pad(seg[..., dc:], (0, dc))
    elif dc < 0:
        seg = F.pad(seg[..., :dc], (-dc, 0))
    return seg


def _as_grad(t, like):
    """A gradient ``t`` for an input of ``like``'s dtype: the real part for
    a real input, then cast."""
    if t.is_complex() and not like.is_complex():
        t = t.real
    return t.to(like.dtype)


def stencil2d_coeffs_grad(g, x, row_offsets, col_offsets, top_halo=None,
                          bot_halo=None):
    """K1's coefficient gradient, plain torch (as the reference's XLA
    autodiff): ``dc[d,i,j] = g[i,j] * conj(x[i+dr_d, j+dc_d])``, zero outside
    the grid but in the halo rows, summed over a batch of ``x``."""
    acc = torch.promote_types(g.dtype, torch.float32)
    M = x.shape[-2]
    x_ext, h = _x_ext(x, halo_rows(row_offsets), acc, top_halo, bot_halo)
    gm = g.to(acc)
    planes = []
    for dr, dc in zip(row_offsets, col_offsets):
        t = gm * _shifted(x_ext, h, M, dr, dc).conj()
        planes.append(t.sum(0) if t.ndim == 3 else t)
    return torch.stack(planes)


def stencil2d_adjoint_planes(coeffs, row_offsets, col_offsets):
    """The planes of K1's adjoint stencil, read at the negated offsets:
    ``out[d, i, j] = conj(coeffs[d, i - dr_d, j - dc_d])``, zero where that
    point leaves the grid."""
    M, ny = coeffs.shape[-2:]
    out = torch.zeros_like(coeffs)
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        src = coeffs[d, max(0, -dr) : M - max(0, dr), max(0, -dc) : ny - max(0, dc)]
        out[d, max(0, dr) : M + min(0, dr), max(0, dc) : ny + min(0, dc)] = src.conj()
    return out


class _Stencil2d(torch.autograd.Function):
    """K1 with its gradient.  The forward is the wrapper's launch (the plain
    version on the CPU); the backward computes the coefficient gradient in
    plain torch (:func:`stencil2d_coeffs_grad`) and the ``x`` gradient as
    the adjoint stencil, K1 on :func:`stencil2d_adjoint_planes` at the
    negated offsets (its plain version on the CPU).  A halo's gradient
    (sharded callers only) is autograd through the plain version."""

    @staticmethod
    def forward(ctx, coeffs, x, row_offsets, col_offsets, top_halo, bot_halo):
        ctx.offsets = (row_offsets, col_offsets)
        ctx.save_for_backward(coeffs, x, top_halo, bot_halo)
        return _stencil2d(coeffs, x, row_offsets, col_offsets, top_halo, bot_halo)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coeffs, x, top, bot = ctx.saved_tensors
        ro, co = ctx.offsets
        need_c, need_x, _, _, need_top, need_bot = ctx.needs_input_grad
        g = g.contiguous()
        d_c = d_x = d_top = d_bot = None
        if need_c:
            d_c = _as_grad(stencil2d_coeffs_grad(g, x, ro, co, top, bot), coeffs)
        if need_x:
            adj = stencil2d_adjoint_planes(coeffs, ro, co)
            d_x = _as_grad(_stencil2d(adj, g, tuple(-r for r in ro), tuple(-c for c in co)), x)
        if need_top or need_bot:
            with torch.enable_grad():
                halos = [None if t is None else t.detach().requires_grad_(need)
                         for t, need in ((top, need_top), (bot, need_bot))]
                y = stencil2d_matvec_plain(coeffs.detach(), x.detach(), ro, co, *halos)
                wanted = [t for t in halos if t is not None and t.requires_grad]
                grads = iter(torch.autograd.grad(y, wanted, g))
            d_top, d_bot = (next(grads) if t is not None and t.requires_grad else None
                            for t in halos)
        return d_c, d_x, None, None, d_top, d_bot


def stencil2d_matvec(coeffs, x, row_offsets, col_offsets, top_halo=None,
                     bot_halo=None, out=None):
    """K1: ``y[i,j] = sum_d coeffs[d,i,j] * x[i+row_offsets[d], j+col_offsets[d]]``.

    ``coeffs``: ``(ndiag, M, ny)``; ``x``: ``(M, ny)`` or a ``(B, M, ny)``
    batch sharing the coefficients.  Out-of-grid neighbours read as zero,
    except rows taken from ``top_halo``/``bot_halo`` (``(h, ny)``, 2-D ``x``
    only).  Output dtype ``promote_types(coeffs, x)``; ``out`` (optional)
    must not overlap ``x``.  Real and complex (complex64, complex128)
    coefficients and vectors.  Differentiable in every tensor argument
    (:class:`_Stencil2d`) but ``out``, which takes no gradient.
    """
    if _wants_grad(coeffs, x, top_halo, bot_halo):
        if out is not None:
            raise TypeError("stencil2d_matvec: out= takes no gradient")
        return _Stencil2d.apply(coeffs, x, tuple(row_offsets), tuple(col_offsets),
                                top_halo, bot_halo)
    return _stencil2d(coeffs, x, row_offsets, col_offsets, top_halo, bot_halo, out)


def _stencil2d(coeffs, x, row_offsets, col_offsets, top_halo=None, bot_halo=None,
               out=None):
    """K1's launch, or its plain version for CPU tensors."""
    if _on_cpu(coeffs, x, top_halo, bot_halo, out):
        y = stencil2d_matvec_plain(coeffs, x, row_offsets, col_offsets,
                                   top_halo, bot_halo)
        return y if out is None else out.copy_(y)

    if (coeffs.dtype, x.dtype) not in _K1_PAIRS:
        raise TypeError(
            f"no stencil kernel for coefficients {coeffs.dtype} and vector "
            f"{x.dtype}; cast one side"
        )
    ndiag, M, ny = coeffs.shape
    batched = x.ndim == 3
    _require(x.ndim in (2, 3) and tuple(x.shape[-2:]) == (M, ny),
             f"x {tuple(x.shape)} does not match the grid {(M, ny)}")
    _require(coeffs.is_contiguous() and x.is_contiguous(),
             "coeffs and x must be contiguous")
    h = halo_rows(row_offsets)
    halos = _halos(top_halo, bot_halo, h, ny, x.dtype, batched)
    out = _grid_out(out, x, torch.promote_types(coeffs.dtype, x.dtype), x)

    lib = _lib()
    dr, dc = _bands(lib, row_offsets, col_offsets)
    with torch.cuda.device(x.device):
        err = lib.krylov_stencil2d(
            _CODES[coeffs.dtype], _CODES[x.dtype], _ptr(coeffs), _ptr(x),
            _ptr(halos[0]), _ptr(halos[1]), _ptr(out),
            x.shape[0] if batched else 1, M, ny, ndiag, dr, dc, h, _stream(x),
        )
    _check(lib, err, "stencil2d_matvec")
    _count(LAUNCHES, "stencil2d_matvec")
    return out


# ---------------------------------------------------------------------------
# K2: constant-coefficient stencil matvec
# ---------------------------------------------------------------------------


def const_stencil2d_matvec_plain(x, bands, row0=None, top_halo=None,
                                 bot_halo=None):
    """Plain version of K2: the reference's halo-extended window with
    boundary masks (``ConstStencilOperator._apply_grid``'s XLA form), bands
    summed in grid order (:func:`grid_order`).

    ``x`` is ``(M, ny)`` or a ``(B, M, ny)`` batch; ``row0`` is the first
    global row (the masks are defined on global rows).  Accumulates in
    float32 for bfloat16 (as the reference's kernel does) and in ``x``'s
    own type otherwise; returns ``x.dtype``.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    M, ny = x.shape[-2:]
    x_ext, h = _x_ext(x, halo_rows([b[0] for b in bands]), acc, top_halo, bot_halo)
    rows = torch.arange(M, device=x.device)[:, None] + (0 if row0 is None else int(row0))
    cols = torch.arange(ny, device=x.device)[None, :]
    y = None
    for dr, dc, w, constraints in grid_order(bands):
        seg = x_ext[..., h + dr : h + dr + M, :]
        if dc:
            seg = torch.roll(seg, -dc, dims=-1)  # the mask below kills the wrap
        m = None
        for stride, size, step in constraints:
            c = (rows // stride) % size
            mm = (c + step >= 0) & (c + step < size)
            m = mm if m is None else m & mm
        if dc:
            mc = (cols + dc >= 0) & (cols + dc < ny)
            m = mc if m is None else m & mc
        term = w * seg
        if m is not None:
            term = torch.where(m, term, 0)
        y = term if y is None else y + term
    return y.to(x.dtype)


# the largest |dr| and |dc| K2's tiled kernel sizes its ring for
# (KRYLOV_K2_MAX_HALO in csrc/stencil.cu)
K2_MAX_HALO = 8
# K2 launches by kernel: "tiled" (the ring of rows in shared memory) and
# "general" (a thread a column)
K2_PATHS = {"tiled": 0, "general": 0}


def k2_tiled(dtype, ny, bands, addresses):
    """Which of K2's two kernels a call takes, from its type, shape and
    alignment alone: the tiled one for float32 vectors whose row length
    ``ny`` is a multiple of 4, whose band offsets stay within
    :data:`K2_MAX_HALO` rows and columns, and whose buffers (``addresses``:
    ``data_ptr()`` of ``x``, ``out`` and any halo rows) all lie on 16-byte
    boundaries, as its 16-byte copies need; the general one for everything
    else (other types, an odd ``ny``, an unaligned view, far bands)."""
    return (dtype == torch.float32 and ny % 4 == 0
            and all(abs(b[0]) <= K2_MAX_HALO and abs(b[1]) <= K2_MAX_HALO for b in bands)
            and all(a % 16 == 0 for a in addresses))


def const_stencil2d_matvec(x, bands, row0=None, top_halo=None, bot_halo=None,
                           out=None):
    """K2: the constant-coefficient stencil ``bands`` applied to ``x``
    (``(M, ny)`` or a ``(B, M, ny)`` batch), masked on global rows
    ``row0 + i``.  Rows outside the grid read as zero, except rows taken
    from ``top_halo``/``bot_halo`` (``(h, ny)``, 2-D ``x`` only).  Returns
    ``x.dtype``; ``out`` (optional) must not overlap ``x``.  :func:`k2_tiled`
    says which of the two kernels a call takes; ``K2_PATHS`` counts them.
    """
    if _on_cpu(x, top_halo, bot_halo, out):
        y = const_stencil2d_matvec_plain(x, bands, row0, top_halo, bot_halo)
        return y if out is None else out.copy_(y)
    _refuse_grad("const_stencil2d_matvec", x, top_halo, bot_halo)

    if x.dtype not in _K2_TYPES:
        raise TypeError(f"no const stencil kernel for vectors of {x.dtype}")
    M, ny = x.shape[-2:]
    batched = x.ndim == 3
    _require(x.ndim in (2, 3) and x.is_contiguous(), "x must be a contiguous grid")
    h = halo_rows([b[0] for b in bands])
    halos = _halos(top_halo, bot_halo, h, ny, x.dtype, batched)
    out = _grid_out(out, x, x.dtype, x)

    tiled = k2_tiled(x.dtype, ny, bands,
                     [t.data_ptr() for t in (x, out, *halos) if t is not None])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.krylov_const_stencil2d(
            _CODES[x.dtype], int(tiled), _ptr(x), _ptr(halos[0]), _ptr(halos[1]), _ptr(out),
            x.shape[0] if batched else 1, M, ny, h,
            0 if row0 is None else int(row0), *_const_bands(lib, bands), _stream(x),
        )
    _check(lib, err, "const_stencil2d_matvec")
    _count(LAUNCHES, "const_stencil2d_matvec")
    _count(K2_PATHS, "tiled" if tiled else "general")
    return out


# ---------------------------------------------------------------------------
# K3 / K5 / K6: fused CG phase A (const / variable coefficients / Jacobi)
# ---------------------------------------------------------------------------


def cg_fused_phase_a_plain(omega, r, p, bands):
    """Plain version of K3: ``p_new = r + omega p``, ``Ap = A p_new`` (by
    the K2 plain version), ``<p_new, Ap>``."""
    pn = r + omega * p
    ap = const_stencil2d_matvec_plain(pn, bands)
    return pn, ap, torch.sum(pn * ap)


def cg_fused_phase_a_var_plain(omega, r, p, coeffs, row_offsets, col_offsets):
    """Plain version of K5: ``p_new = r + omega p``, ``Ap = A p_new`` (by
    the K1 plain version), ``<p_new, Ap>``."""
    pn = r + omega * p
    ap = stencil2d_matvec_plain(coeffs, pn, row_offsets, col_offsets)
    return pn, ap, torch.sum(pn * ap)


def cg_fused_phase_a_var_jac_plain(omega, r, p, coeffs, dinv, row_offsets,
                                   col_offsets):
    """Plain version of K6: ``p_new = dinv * r + omega p``, ``Ap = A p_new``
    (by the K1 plain version), ``<p_new, Ap>``."""
    pn = dinv * r + omega * p
    ap = stencil2d_matvec_plain(coeffs, pn, row_offsets, col_offsets)
    return pn, ap, torch.sum(pn * ap)


def _phase_a_outputs(r, p, out):
    for t in (r, p):
        _require(t.dtype == torch.float32, "the fused CG phases are float32-only")
        _require(t.ndim == 2 and t.shape == r.shape and t.is_contiguous(),
                 "r and p must be contiguous grids of one shape")
    pn_out, ap_out = (None, None) if out is None else out
    pn_out = _grid_out(pn_out, r, torch.float32, r, p)
    ap_out = _grid_out(ap_out, r, torch.float32, r, p, pn_out)
    return pn_out, ap_out


def _phase_a(name, launch, omega, r, p, out):
    """Allocate K3/K5/K6's outputs and scratch, launch, count."""
    pn_out, ap_out = _phase_a_outputs(r, p, out)
    _require(omega.dtype == torch.float32, "omega must be float32")
    lib = _lib()
    M, ny = r.shape
    partials = torch.empty(lib.krylov_phase_a_partials(M, ny), dtype=torch.float32,
                           device=r.device)
    pap = torch.empty((), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = launch(lib, pn_out, ap_out, partials, pap)
    _check(lib, err, name)
    _count(LAUNCHES, name)
    return pn_out, ap_out, pap


def cg_fused_phase_a(omega, r, p, bands, out=None):
    """K3: returns ``(p_new, Ap, pAp)`` in one pass over const ``bands``
    (float32; no ``row0``/halos: unsharded).

    ``omega`` is a 0-d tensor on the vectors' device.  ``out=(p_new, Ap)``
    (optional) are written in place and must overlap neither ``r`` nor
    ``p``: the caller ping-pongs two ``p`` buffers.
    """
    omega = torch.as_tensor(omega, dtype=r.dtype, device=r.device)
    if _on_cpu(omega, r, p, *(out or ())):
        pn, ap, pap = cg_fused_phase_a_plain(omega, r, p, bands)
        if out is not None:
            pn, ap = out[0].copy_(pn), out[1].copy_(ap)
        return pn, ap, pap
    _refuse_grad("cg_fused_phase_a", omega, r, p)

    def launch(lib, pn, ap, partials, pap):
        return lib.krylov_cg_phase_a_const(
            _ptr(omega), _ptr(r), _ptr(p), _ptr(pn), _ptr(ap), _ptr(partials),
            _ptr(pap), *r.shape, *_const_bands(lib, bands), _stream(r),
        )

    return _phase_a("cg_fused_phase_a", launch, omega, r, p, out)


def cg_fused_phase_a_var(omega, r, p, coeffs, row_offsets, col_offsets, out=None):
    """K5: returns ``(p_new, Ap, pAp)`` in one pass (float32).

    ``omega`` is a 0-d tensor on the vectors' device.  ``out=(p_new, Ap)``
    (optional) are written in place and must overlap neither ``r`` nor
    ``p``: the caller ping-pongs two ``p`` buffers.
    """
    omega = torch.as_tensor(omega, dtype=r.dtype, device=r.device)
    if _on_cpu(omega, r, p, coeffs, *(out or ())):
        pn, ap, pap = cg_fused_phase_a_var_plain(
            omega, r, p, coeffs, row_offsets, col_offsets
        )
        if out is not None:
            pn, ap = out[0].copy_(pn), out[1].copy_(ap)
        return pn, ap, pap
    _refuse_grad("cg_fused_phase_a_var", omega, r, p, coeffs)

    _require(coeffs.dtype == torch.float32 and coeffs.is_contiguous()
             and tuple(coeffs.shape[1:]) == tuple(r.shape),
             "coeffs must be a contiguous float32 (ndiag, M, ny) stack")

    def launch(lib, pn, ap, partials, pap):
        dr, dc = _bands(lib, row_offsets, col_offsets)
        return lib.krylov_cg_phase_a_var(
            _ptr(omega), _ptr(coeffs), _ptr(r), _ptr(p), _ptr(pn), _ptr(ap),
            _ptr(partials), _ptr(pap), *r.shape, len(row_offsets), dr, dc,
            _stream(r),
        )

    return _phase_a("cg_fused_phase_a_var", launch, omega, r, p, out)


def cg_fused_phase_a_var_jac(omega, r, p, coeffs, dinv, row_offsets, col_offsets,
                             out=None):
    """K6: returns ``(p_new, Ap, pAp)`` of Jacobi-preconditioned CG in one
    pass (float32): ``p_new = dinv * r + omega * p`` with the ``(M, ny)``
    plane ``dinv = 1 / diag(A)``.

    ``omega`` is a 0-d tensor on the vectors' device.  ``out=(p_new, Ap)``
    (optional) are written in place and must overlap neither ``r`` nor
    ``p``: the caller ping-pongs two ``p`` buffers.
    """
    omega = torch.as_tensor(omega, dtype=r.dtype, device=r.device)
    if _on_cpu(omega, r, p, coeffs, dinv, *(out or ())):
        pn, ap, pap = cg_fused_phase_a_var_jac_plain(
            omega, r, p, coeffs, dinv, row_offsets, col_offsets
        )
        if out is not None:
            pn, ap = out[0].copy_(pn), out[1].copy_(ap)
        return pn, ap, pap
    _refuse_grad("cg_fused_phase_a_var_jac", omega, r, p, coeffs, dinv)

    _require(coeffs.dtype == torch.float32 and coeffs.is_contiguous()
             and tuple(coeffs.shape[1:]) == tuple(r.shape),
             "coeffs must be a contiguous float32 (ndiag, M, ny) stack")
    _require(dinv.dtype == torch.float32 and dinv.is_contiguous()
             and dinv.shape == r.shape,
             "dinv must be a contiguous float32 grid of r's shape")
    for t in out or ():
        _require(t is None or _disjoint(t, dinv), "out must not overlap an input")

    def launch(lib, pn, ap, partials, pap):
        dr, dc = _bands(lib, row_offsets, col_offsets)
        return lib.krylov_cg_phase_a_var_jac(
            _ptr(omega), _ptr(coeffs), _ptr(r), _ptr(p), _ptr(dinv), _ptr(pn),
            _ptr(ap), _ptr(partials), _ptr(pap), *r.shape, len(row_offsets), dr,
            dc, _stream(r),
        )

    return _phase_a("cg_fused_phase_a_var_jac", launch, omega, r, p, out)


# ---------------------------------------------------------------------------
# K4 / K7: fused CG phase B (plain / Jacobi)
# ---------------------------------------------------------------------------


def cg_fused_phase_b_plain(alpha, y, r, p, ap):
    """Plain version of K4: ``y += alpha p``, ``r -= alpha Ap`` in place,
    returns ``(y, r, <r, r>)``."""
    y += alpha * p
    r -= alpha * ap
    return y, r, torch.sum(r * r)


def cg_fused_phase_b_jac_plain(alpha, y, r, p, ap, dinv):
    """Plain version of K7: ``y += alpha p``, ``r -= alpha Ap`` in place,
    returns ``(y, r, <r, dinv r>)``, summed as ``r * (dinv * r)``."""
    y += alpha * p
    r -= alpha * ap
    return y, r, torch.sum(r * (dinv * r))


def _phase_b(name, alpha, y, r, p, ap, dinv=None):
    """Check K4/K7's operands, allocate the scratch, launch, count."""
    reads = (p, ap) if dinv is None else (p, ap, dinv)
    _refuse_grad(name, alpha, y, r, *reads)
    for t in (alpha, y, r) + reads:
        _require(t.dtype == torch.float32, f"{name} is float32-only")
    for t in (y,) + reads:
        _require(t.shape == r.shape and t.is_contiguous(),
                 "y, r, p, Ap and dinv must be contiguous and of one shape")
    _require(r.is_contiguous(), "r must be contiguous")
    _require(_disjoint(y, r), "y and r must not overlap")
    for t in reads:
        _require(_disjoint(t, y) and _disjoint(t, r),
                 "p, Ap and dinv must not overlap the updated y and r")

    lib = _lib()
    n = r.numel()
    partials = torch.empty(lib.krylov_phase_b_partials(n), dtype=torch.float32,
                           device=r.device)
    rho = torch.empty((), dtype=torch.float32, device=r.device)
    head = (_ptr(alpha), _ptr(y), _ptr(r), _ptr(p), _ptr(ap))
    tail = (_ptr(partials), _ptr(rho), n, _stream(r))
    with torch.cuda.device(r.device):
        if dinv is None:
            err = lib.krylov_cg_phase_b(*head, *tail)
        else:
            err = lib.krylov_cg_phase_b_jac(*head, _ptr(dinv), *tail)
    _check(lib, err, name)
    _count(LAUNCHES, name)
    return y, r, rho


def cg_fused_phase_b(alpha, y, r, p, ap):
    """K4: updates ``y`` and ``r`` in place and returns ``(y, r, rho)`` with
    ``rho = <r_new, r_new>`` (float32; ``alpha`` a 0-d device tensor)."""
    alpha = torch.as_tensor(alpha, dtype=r.dtype, device=r.device)
    if _on_cpu(alpha, y, r, p, ap):
        return cg_fused_phase_b_plain(alpha, y, r, p, ap)
    return _phase_b("cg_fused_phase_b", alpha, y, r, p, ap)


def cg_fused_phase_b_jac(alpha, y, r, p, ap, dinv):
    """K7: updates ``y`` and ``r`` in place and returns ``(y, r, rho)`` with
    ``rho = <r_new, dinv * r_new>`` (float32; ``alpha`` a 0-d device tensor,
    ``dinv`` the ``(M, ny)`` plane ``1 / diag(A)``)."""
    alpha = torch.as_tensor(alpha, dtype=r.dtype, device=r.device)
    if _on_cpu(alpha, y, r, p, ap, dinv):
        return cg_fused_phase_b_jac_plain(alpha, y, r, p, ap, dinv)
    return _phase_b("cg_fused_phase_b_jac", alpha, y, r, p, ap, dinv)


# ---------------------------------------------------------------------------
# K8 / K9: damped-Jacobi sweeps (multigrid smoothing and residuals)
# ---------------------------------------------------------------------------


def jacobi_sweep_const_plain(w, z, r, bands, update=True):
    """Plain version of K8: ``z + w * (r - A z)`` or ``r - A z`` (``A z``
    by the K2 plain version)."""
    res = r - const_stencil2d_matvec_plain(z, bands)
    return z + w * res if update else res


def jacobi_sweep_var_plain(w, z, r, coeffs, row_offsets, col_offsets, update=True):
    """Plain version of K9: ``z + w * (r - A z)`` with a weight plane ``w``,
    or ``r - A z`` (``A z`` by the K1 plain version)."""
    res = r - stencil2d_matvec_plain(coeffs, z, row_offsets, col_offsets)
    return z + w * res if update else res


def _sweep_checks(z, r, out, *planes):
    _require(z.dtype in _SWEEP_TYPES, f"no Jacobi sweep kernel for {z.dtype}")
    _require(r.dtype == z.dtype, "z and r must share one dtype")
    for t in planes:
        _require((t.dtype, z.dtype) in _K9_PAIRS and t.dtype == planes[0].dtype,
                 "the planes must share one dtype, real or the vectors' own")
    for t in (z, r) + planes:
        _require(t.is_contiguous() and tuple(t.shape[-2:]) == tuple(z.shape),
                 "z, r and the planes must be contiguous grids of z's shape")
    _require(z.ndim == 2, "the sweeps take one (M, ny) grid")
    return _grid_out(out, z, z.dtype, z, r)


def jacobi_sweep_const(w, z, r, bands, update=True, out=None):
    """K8: ``z + w * (r - A z)`` (``update=True``) or the residual
    ``r - A z`` for the const ``bands`` on one ``(M, ny)`` grid, in one
    pass (float32, float64, complex64, complex128).

    ``w`` is the damped-Jacobi weight as a Python float (the caller rounds
    it to the operator's dtype; residual mode ignores it).  ``out``
    (optional) must overlap neither ``z`` nor ``r``.
    """
    if _on_cpu(z, r, out):
        y = jacobi_sweep_const_plain(w, z, r, bands, update)
        return y if out is None else out.copy_(y)
    _refuse_grad("jacobi_sweep_const", z, r)

    out = _sweep_checks(z, r, out)
    lib = _lib()
    with torch.cuda.device(z.device):
        err = lib.krylov_jacobi_sweep_const(
            _CODES[z.dtype], float(w) if update else 0.0, _ptr(z), _ptr(r), _ptr(out),
            int(update), *z.shape, *_const_bands(lib, bands), _stream(z),
        )
    _check(lib, err, "jacobi_sweep_const")
    _count(LAUNCHES, "jacobi_sweep_const")
    return out


def jacobi_sweep_var(w, z, r, coeffs, row_offsets, col_offsets, update=True,
                     out=None):
    """K9: ``z + w * (r - A z)`` with the ``(M, ny)`` weight plane ``w``
    (``update=True``; ``w = omega / diag``) or the residual ``r - A z``
    (``w`` unread) for the coefficient planes ``coeffs`` ``(ndiag, M, ny)``
    on one ``(M, ny)`` grid, in one pass.  Vectors are float32, float64,
    complex64 or complex128; the planes real or of the vectors' type.
    ``out`` (optional) must overlap neither ``z`` nor ``r``.
    """
    w = w if update else None
    if _on_cpu(w, z, r, coeffs, out):
        y = jacobi_sweep_var_plain(w, z, r, coeffs, row_offsets, col_offsets, update)
        return y if out is None else out.copy_(y)
    _refuse_grad("jacobi_sweep_var", w, z, r, coeffs)

    out = _sweep_checks(z, r, out, coeffs, *(() if w is None else (w,)))
    lib = _lib()
    dr, dc = _bands(lib, row_offsets, col_offsets)
    with torch.cuda.device(z.device):
        err = lib.krylov_jacobi_sweep_var(
            _CODES[coeffs.dtype], _CODES[z.dtype], _ptr(coeffs), _ptr(w), _ptr(z), _ptr(r), _ptr(out),
            *z.shape, len(row_offsets), dr, dc, _stream(z),
        )
    _check(lib, err, "jacobi_sweep_var")
    _count(LAUNCHES, "jacobi_sweep_var")
    return out
