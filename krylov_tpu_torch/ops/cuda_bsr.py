"""Block-sparse SpMM: the CUDA wrapper of K12, its plain PyTorch version and
its launch counter.

Counterpart of ``krylov_tpu.ops.pallas_bsr`` (source in
``krylov_tpu_torch/csrc/bsr.cu``): :func:`bsr_spmm` computes ``Y = A X`` for
ELL-padded BSR, ``data (nbrows * max_blocks, R, C)`` and ``cols (nbrows,
max_blocks)``, at full precision in the data's own type (the reference's
``Precision.HIGHEST``), for float32, float64, complex64 and complex128 and
any ``R``, ``C`` and ``k``.  The reference's ``supports()`` gate and
``_pick_batch`` are TPU tiling rules and have no counterpart here.

On CPU tensors the wrapper runs its plain version; on a CUDA device it
launches the kernel or raises.  Each launch adds one to
``LAUNCHES["bsr_spmm"]``.
"""

import ctypes
import functools

import torch

from .cuda_stencil import _CODES, _check, _on_cpu, _ptr, _require, _stream

LAUNCHES = {"bsr_spmm": 0}

_TYPES = {torch.float32, torch.float64, torch.complex64, torch.complex128}


def reset_launches():
    LAUNCHES["bsr_spmm"] = 0


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.krylov_bsr_spmm.argtypes = [i32, vp, vp, vp, vp] + [i32] * 5 + [vp]
    lib.krylov_bsr_spmm.restype = i32
    lib.krylov_error_string.argtypes = [i32]
    lib.krylov_error_string.restype = ctypes.c_char_p
    return lib


def bsr_spmm_plain(data, cols, x):
    """Plain version of K12, the reference's portable contraction: gather
    the x slab of every stored block, one batched block product (einsum),
    then the sum of each block row's ``max_blocks`` products."""
    nbrows, max_blocks = cols.shape
    _, R, C = data.shape
    k = x.shape[1]
    dt = torch.promote_types(data.dtype, x.dtype)
    xg = x.to(dt).reshape(-1, C, k).index_select(0, cols.reshape(-1).long())
    prod = torch.einsum("brc,bck->brk", data.to(dt), xg)
    return prod.reshape(nbrows, max_blocks, R, k).sum(dim=1).reshape(nbrows * R, k)


def bsr_spmm(data, cols, x):
    """K12: ``Y = A X``, ``x`` of shape ``(nbcols * C, k)``, ``Y`` of shape
    ``(nbrows * R, k)`` in ``promote_types(data, x)``."""
    if _on_cpu(data, cols, x):
        return bsr_spmm_plain(data, cols, x)
    dt = torch.promote_types(data.dtype, x.dtype)
    _require(dt in _TYPES, f"no BSR kernel for {dt}")
    data = data.to(dt).contiguous()
    x = x.to(dt).contiguous()
    _require(cols.dtype == torch.int32 and cols.is_contiguous(), "cols must be contiguous int32")
    nbrows, max_blocks = cols.shape
    nb, R, C = data.shape
    _require(nb == nbrows * max_blocks, "data and cols disagree on the block count")
    _require(x.ndim == 2 and x.shape[0] % C == 0, f"x {tuple(x.shape)} is not (nbcols * {C}, k)")
    k = x.shape[1]
    y = torch.empty((nbrows * R, k), dtype=dt, device=x.device)
    if k == 0 or nbrows == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.krylov_bsr_spmm(_CODES[dt], _ptr(data), _ptr(cols), _ptr(x), _ptr(y),
                                  nbrows, max_blocks, R, C, k, _stream(x))
    _check(lib, err, "bsr_spmm")
    LAUNCHES["bsr_spmm"] += 1
    return y
