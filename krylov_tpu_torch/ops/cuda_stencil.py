"""Grid-stencil kernels: CUDA wrappers, their plain PyTorch versions and
launch counters.

Counterpart of ``krylov_tpu.ops.pallas_stencil`` for the three kernels the
grid-stencil CG path runs (sources in ``krylov_tpu_torch/csrc/stencil.cu``):

* K1 :func:`stencil2d_matvec` — ``y[i,j] = sum_d c[d,i,j] * x[i+dr_d, j+dc_d]``,
* K5 :func:`cg_fused_phase_a_var` — ``p = r + omega p``, ``Ap``, ``<p, Ap>``,
* K4 :func:`cg_fused_phase_b` — ``y += alpha p``, ``r -= alpha Ap``, ``<r, r>``.

A wrapper runs its plain version only when its tensors lie on the CPU; on
a CUDA device it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``; the plain versions count nothing.

Unlike the TPU kernels, K1 and K5 never write into a buffer they read:
blocks run in parallel and block i+1 reads rows of block i.  Scalars
(omega, alpha, pAp, rho) stay in 0-d device tensors.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

LAUNCHES = {"stencil2d_matvec": 0, "cg_fused_phase_a_var": 0, "cg_fused_phase_b": 0}

# dtype codes of csrc/stencil.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# (coefficient dtype, vector dtype) pairs K1 is instantiated for
_K1_PAIRS = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64),
}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def halo_rows(row_offsets):
    """Rows a stencil reads above or below its own: ``max |dr|``."""
    return max(max(0, -min(row_offsets)), max(0, max(row_offsets)))


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.krylov_error_string.argtypes = [i32]
    lib.krylov_error_string.restype = ctypes.c_char_p
    lib.krylov_max_bands.argtypes = []
    lib.krylov_max_bands.restype = i32
    lib.krylov_phase_a_partials.argtypes = [i32, i32]
    lib.krylov_phase_a_partials.restype = i64
    lib.krylov_phase_b_partials.argtypes = [i64]
    lib.krylov_phase_b_partials.restype = i64
    lib.krylov_stencil2d.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, i32, vp
    ]
    lib.krylov_stencil2d.restype = i32
    lib.krylov_cg_phase_a_var.argtypes = [vp] * 8 + [i32, i32, i32, vp, vp, vp]
    lib.krylov_cg_phase_a_var.restype = i32
    lib.krylov_cg_phase_b.argtypes = [vp] * 7 + [i64, vp]
    lib.krylov_cg_phase_b.restype = i32
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


def _disjoint(a, b):
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a1 <= b0 or b1 <= a0


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
    M, ny = x.shape[-2:]
    h_real = halo_rows(row_offsets)
    h = max(h_real, 1)
    lead = tuple(x.shape[:-2])

    def edge(halo):
        if halo is None or h_real == 0:
            return torch.zeros(lead + (h, ny), dtype=acc, device=x.device)
        return halo.to(x.dtype).to(acc).expand(lead + (h, ny))

    x_ext = torch.cat([edge(top_halo), x.to(acc), edge(bot_halo)], dim=-2)
    y = None
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        seg = x_ext[..., h + dr : h + dr + M, :]
        if dc > 0:
            seg = F.pad(seg[..., dc:], (0, dc))
        elif dc < 0:
            seg = F.pad(seg[..., :dc], (-dc, 0))
        term = coeffs[d].to(acc) * seg
        y = term if y is None else y + term
    return y.to(out_dtype)


def stencil2d_matvec(coeffs, x, row_offsets, col_offsets, top_halo=None,
                     bot_halo=None, out=None):
    """K1: ``y[i,j] = sum_d coeffs[d,i,j] * x[i+row_offsets[d], j+col_offsets[d]]``.

    ``coeffs``: ``(ndiag, M, ny)``; ``x``: ``(M, ny)`` or a ``(B, M, ny)``
    batch sharing the coefficients.  Out-of-grid neighbours read as zero,
    except rows taken from ``top_halo``/``bot_halo`` (``(h, ny)``, 2-D ``x``
    only).  Output dtype ``promote_types(coeffs, x)``; ``out`` (optional)
    must not overlap ``x``.
    """
    if _on_cpu(coeffs, x, top_halo, bot_halo, out):
        y = stencil2d_matvec_plain(coeffs, x, row_offsets, col_offsets,
                                   top_halo, bot_halo)
        return y if out is None else out.copy_(y)

    if coeffs.is_complex() or x.is_complex():
        raise NotImplementedError("complex stencils have no CUDA kernel yet")
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
    halos = []
    for halo in (top_halo, bot_halo):
        if halo is None or h == 0:
            halos.append(None)
            continue
        _require(not batched, "halos apply to a single (M, ny) grid")
        _require(tuple(halo.shape) == (h, ny), f"halo {tuple(halo.shape)} != {(h, ny)}")
        halos.append(halo.to(x.dtype).contiguous())
    y_dtype = torch.promote_types(coeffs.dtype, x.dtype)
    if out is None:
        out = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    else:
        _require(out.dtype == y_dtype and out.shape == x.shape and out.is_contiguous(),
                 "out must be a contiguous tensor of x's shape and the output dtype")
        _require(_disjoint(out, x), "out must not overlap x")

    lib = _lib()
    dr, dc = _bands(lib, row_offsets, col_offsets)
    with torch.cuda.device(x.device):
        err = lib.krylov_stencil2d(
            _CODES[coeffs.dtype], _CODES[x.dtype], _ptr(coeffs), _ptr(x),
            _ptr(halos[0]), _ptr(halos[1]), _ptr(out),
            x.shape[0] if batched else 1, M, ny, ndiag, dr, dc, h, _stream(x),
        )
    _check(lib, err, "stencil2d_matvec")
    LAUNCHES["stencil2d_matvec"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: fused CG phase A (variable coefficients)
# ---------------------------------------------------------------------------


def cg_fused_phase_a_var_plain(omega, r, p, coeffs, row_offsets, col_offsets):
    """Plain version of K5: ``p_new = r + omega p``, ``Ap = A p_new`` (by
    the K1 plain version), ``<p_new, Ap>``."""
    pn = r + omega * p
    ap = stencil2d_matvec_plain(coeffs, pn, row_offsets, col_offsets)
    return pn, ap, torch.sum(pn * ap)


def cg_fused_phase_a_var(omega, r, p, coeffs, row_offsets, col_offsets, out=None):
    """K5: returns ``(p_new, Ap, pAp)`` in one pass (float32).

    ``omega`` is a 0-d tensor on the vectors' device.  ``out=(p_new, Ap)``
    (optional) are written in place and must overlap neither ``r`` nor
    ``p``: the caller ping-pongs two ``p`` buffers.
    """
    pn_out, ap_out = (None, None) if out is None else out
    omega = torch.as_tensor(omega, dtype=r.dtype, device=r.device)
    if _on_cpu(omega, r, p, coeffs, pn_out, ap_out):
        pn, ap, pap = cg_fused_phase_a_var_plain(
            omega, r, p, coeffs, row_offsets, col_offsets
        )
        if out is not None:
            pn, ap = pn_out.copy_(pn), ap_out.copy_(ap)
        return pn, ap, pap

    ndiag, M, ny = coeffs.shape
    for t in (r, p, coeffs, omega):
        _require(t.dtype == torch.float32, "cg_fused_phase_a_var is float32-only")
    for t in (r, p):
        _require(tuple(t.shape) == (M, ny) and t.is_contiguous(),
                 f"r and p must be contiguous {(M, ny)} grids")
    _require(coeffs.is_contiguous(), "coeffs must be contiguous")
    if out is None:
        pn_out, ap_out = torch.empty_like(r), torch.empty_like(r)
    for o in (pn_out, ap_out):
        _require(o.dtype == torch.float32 and o.shape == r.shape and o.is_contiguous(),
                 "outputs must be contiguous float32 grids")
        _require(_disjoint(o, r) and _disjoint(o, p),
                 "p_new and Ap must not overlap r or p")
    _require(_disjoint(pn_out, ap_out), "p_new and Ap must not overlap")

    lib = _lib()
    dr, dc = _bands(lib, row_offsets, col_offsets)
    partials = torch.empty(lib.krylov_phase_a_partials(M, ny), dtype=torch.float32,
                           device=r.device)
    pap = torch.empty((), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.krylov_cg_phase_a_var(
            _ptr(omega), _ptr(coeffs), _ptr(r), _ptr(p), _ptr(pn_out),
            _ptr(ap_out), _ptr(partials), _ptr(pap), M, ny, ndiag, dr, dc,
            _stream(r),
        )
    _check(lib, err, "cg_fused_phase_a_var")
    LAUNCHES["cg_fused_phase_a_var"] += 1
    return pn_out, ap_out, pap


# ---------------------------------------------------------------------------
# K4: fused CG phase B
# ---------------------------------------------------------------------------


def cg_fused_phase_b_plain(alpha, y, r, p, ap):
    """Plain version of K4: ``y += alpha p``, ``r -= alpha Ap`` in place,
    returns ``(y, r, <r, r>)``."""
    y += alpha * p
    r -= alpha * ap
    return y, r, torch.sum(r * r)


def cg_fused_phase_b(alpha, y, r, p, ap):
    """K4: updates ``y`` and ``r`` in place and returns ``(y, r, rho)`` with
    ``rho = <r_new, r_new>`` (float32; ``alpha`` a 0-d device tensor)."""
    alpha = torch.as_tensor(alpha, dtype=r.dtype, device=r.device)
    if _on_cpu(alpha, y, r, p, ap):
        return cg_fused_phase_b_plain(alpha, y, r, p, ap)

    for t in (alpha, y, r, p, ap):
        _require(t.dtype == torch.float32, "cg_fused_phase_b is float32-only")
    for t in (y, p, ap):
        _require(t.shape == r.shape and t.is_contiguous(),
                 "y, r, p and Ap must be contiguous and of one shape")
    _require(r.is_contiguous(), "r must be contiguous")
    _require(_disjoint(y, r), "y and r must not overlap")
    for t in (p, ap):
        _require(_disjoint(t, y) and _disjoint(t, r),
                 "p and Ap must not overlap the updated y and r")

    lib = _lib()
    n = r.numel()
    partials = torch.empty(lib.krylov_phase_b_partials(n), dtype=torch.float32,
                           device=r.device)
    rho = torch.empty((), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.krylov_cg_phase_b(
            _ptr(alpha), _ptr(y), _ptr(r), _ptr(p), _ptr(ap), _ptr(partials),
            _ptr(rho), n, _stream(r),
        )
    _check(lib, err, "cg_fused_phase_b")
    LAUNCHES["cg_fused_phase_b"] += 1
    return y, r, rho
