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
launches one of K12's two kernels or raises: the streamed one (a warp
streams 32 rows of a block row through a ring in shared memory) where
:func:`k12_streamed` says so, from type, shape and alignment alone, and the
general one otherwise.  Each launch adds one to ``LAUNCHES["bsr_spmm"]`` and
to the kernel's entry of ``K12_PATHS``.  A launch captured into the
``while_loop`` driver's CUDA graph counts once for each step that a replay
runs (:func:`krylov_tpu_torch._graphs.count`).

The adjoint ``A^H G`` (:class:`BsrTranspose`) is K12 again, on the block
transpose of ``A^H`` built once as ELL-padded BSR; where a dense block
column would blow up that padding, a column-sorted segment sum of the
block products in plain torch.  Both sum in one fixed order on every
device; ``ADJOINT_PATHS`` counts the products each route takes.

Gradients (:class:`_BsrSpmm`, on both devices): the data gradient is plain
torch, block by block, as the reference's XLA autodiff; the ``X``
gradient is the adjoint above on the CPU, and on the card it is refused
(a solve differentiates through ``b`` with
:func:`krylov_tpu_torch.diffable.solve`, which needs none).
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from .._graphs import count as _count
from .cuda_stencil import _CODES, _as_grad, _check, _on_cpu, _ptr, _require, _stream, _wants_grad
from .sparse import _segment_sum

LAUNCHES = {"bsr_spmm": 0}

_TYPES = {torch.float32, torch.float64, torch.complex64, torch.complex128}


# the most bytes ``k`` columns of one row of X may take in the streamed
# kernel (KRYLOV_BSR_ROW_BYTES in csrc/bsr.cu): 32 float32 columns
K12_ROW_BYTES = 128
# K12 launches by kernel: "streamed" (a warp per 32 rows of a block row, the
# block data through a ring in shared memory) and "general" (a warp per
# output row and column tile)
K12_PATHS = {"streamed": 0, "general": 0}
# adjoint products by route (BsrTranspose): "k12", K12 on the block
# transpose; "segment", a column-sorted segment sum of the block products
ADJOINT_PATHS = {"k12": 0, "segment": 0}
# the most blocks the transpose's ELL padding may hold, over the blocks the
# operator stores, before a product takes the segment route
ADJOINT_PAD_RATIO = 2


def reset_launches():
    for counts in (LAUNCHES, K12_PATHS, ADJOINT_PATHS):
        for name in counts:
            counts[name] = 0


def k12_streamed(dtype, C, k, addresses):
    """Which of K12's two kernels a call takes, from its type, shape and
    alignment alone: the streamed one when a block's row is a whole number
    of 16-byte pieces (``C * itemsize % 16 == 0``: ``C % 4 == 0`` in
    float32), the ``k`` columns of a row of ``x`` fit
    :data:`K12_ROW_BYTES` (32 float32 columns, 8 complex128 ones) and the
    buffers (``addresses``: ``data_ptr()`` of ``data``, ``x`` and the
    output) lie on 16-byte boundaries, as its 16-byte copies need; the
    general one for everything else."""
    item = dtype.itemsize
    return ((C * item) % 16 == 0 and k * item <= K12_ROW_BYTES
            and all(a % 16 == 0 for a in addresses))


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.krylov_bsr_spmm.argtypes = [i32, i32, vp, vp, vp, vp] + [i32] * 5 + [vp]
    lib.krylov_bsr_spmm.restype = i32
    lib.krylov_bsr_row_bytes.argtypes = []
    lib.krylov_bsr_row_bytes.restype = i32
    lib.krylov_error_string.argtypes = [i32]
    lib.krylov_error_string.restype = ctypes.c_char_p
    if lib.krylov_bsr_row_bytes() != K12_ROW_BYTES:
        raise RuntimeError("K12_ROW_BYTES differs from csrc/bsr.cu's KRYLOV_BSR_ROW_BYTES")
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


def bsr_spmm_data_grad(g, cols, x, R, C):
    """K12's data gradient, plain torch: ``dd[r * max_blocks + s] =
    G[block row r] @ X[block cols[r, s]]^H`` (``(R, C)`` a block), in
    ``g``'s type."""
    nbrows, max_blocks = cols.shape
    k = x.shape[1]
    gb = g.reshape(nbrows, 1, R, k).expand(nbrows, max_blocks, R, k).reshape(-1, R, k)
    xg = x.to(g.dtype).reshape(-1, C, k).index_select(0, cols.reshape(-1).long())
    return torch.einsum("brk,bck->brc", gb, xg.conj())


class BsrTranspose:
    """``A^H`` of the ELL-padded BSR ``(data, cols)`` with ``nbcols`` block
    columns, built once on the data's device (it reads the device: outside
    any CUDA-graph capture); calling it on ``G (nbrows * R, k)`` gives
    ``A^H G (nbcols * C, k)``.

    The stored blocks, without the operator's ELL pads (zero blocks at
    block column 0), are sorted by block column, each column's in ascending
    block row, and conjugate-transposed to ``(C, R)``.  Where the block
    columns that hold a block, ``width`` blocks each at most, fit in
    :data:`ADJOINT_PAD_RATIO` times the blocks the operator stores
    (``route == "k12"``), they become the block rows of an ELL-padded BSR
    (pads at block column 0 with zero blocks, as ``from_scipy`` pads) and
    a product is one K12 launch (:func:`bsr_spmm`), its rows copied into
    the output's block columns where some column holds no block.  Else (a
    dense block column, or no block at all: ``route == "segment"``) a
    product is the gathered block products summed per column by
    ``segment_reduce``, plain torch.
    K12 sums a block row's slots in one order and ``segment_reduce`` each
    segment in one order, so either product repeats bit for bit."""

    def __init__(self, data, cols, nbcols):
        nbrows, max_blocks = cols.shape
        _, R, C = data.shape
        dev = data.device
        self.nbcols, self.blocksize = int(nbcols), (R, C)
        bcol = cols.reshape(-1).long()
        pad = (bcol == 0) & ~(data != 0).reshape(bcol.numel(), -1).any(dim=1)
        src = torch.nonzero(~pad).reshape(-1)
        src = src.index_select(0, torch.argsort(bcol.index_select(0, src), stable=True))
        col = bcol.index_select(0, src)
        self.brow = torch.div(src, max_blocks, rounding_mode="floor")
        blocks = data.index_select(0, src).transpose(1, 2)
        blocks = blocks.conj_physical() if blocks.is_complex() else blocks
        counts = torch.bincount(col, minlength=self.nbcols)
        held = torch.nonzero(counts).reshape(-1)
        width = int(counts.max()) if src.numel() else 0
        self.route = ("k12" if 0 < held.numel() * width <= ADJOINT_PAD_RATIO * data.shape[0]
                      else "segment")
        if self.route == "segment":
            self.data = blocks.contiguous()
            self.indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                     torch.cumsum(counts, 0)])
            return
        # the transpose's block row of each held block column, and each
        # block's slot in it
        row_of = torch.cumsum(counts != 0, 0) - 1
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(src.numel(), device=dev) - starts.index_select(0, col)
        pos = row_of.index_select(0, col) * width + slot
        nt = held.numel() * width
        self.data = torch.zeros((nt, C, R), dtype=data.dtype, device=dev).index_copy(
            0, pos, blocks)
        self.cols = torch.zeros(nt, dtype=torch.int32, device=dev).index_copy(
            0, pos, self.brow.int()).reshape(-1, width)
        # the output's block columns, where some hold no block
        self.held = None if held.numel() == self.nbcols else held

    @property
    def nbytes(self):
        """The device bytes the transpose keeps."""
        return sum(t.numel() * t.element_size() for t in vars(self).values()
                   if isinstance(t, torch.Tensor))

    def __call__(self, g):
        _count(ADJOINT_PATHS, self.route)
        R, C = self.blocksize
        k = g.shape[1]
        if self.route == "segment":
            dt = torch.promote_types(self.data.dtype, g.dtype)
            gb = g.to(dt).reshape(-1, R, k).index_select(0, self.brow)
            prod = torch.einsum("bcr,brk->bck", self.data.to(dt), gb)
            return _segment_sum(prod, self.indptr).reshape(self.nbcols * C, k)
        y = bsr_spmm(self.data, self.cols, g)
        if self.held is None:
            return y
        out = torch.zeros((self.nbcols, C, k), dtype=y.dtype, device=y.device)
        return out.index_copy_(0, self.held, y.reshape(-1, C, k)).reshape(self.nbcols * C, k)


class _BsrSpmm(torch.autograd.Function):
    """K12 with its gradient: the forward is the wrapper's launch (the
    plain version on the CPU), the backward plain torch."""

    @staticmethod
    def forward(ctx, data, cols, x):
        ctx.save_for_backward(data, cols, x)
        return _bsr_spmm(data, cols, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, cols, x = ctx.saved_tensors
        _, R, C = data.shape
        d_data = d_x = None
        if ctx.needs_input_grad[0]:
            d_data = _as_grad(bsr_spmm_data_grad(g, cols, x, R, C), data)
        if ctx.needs_input_grad[2]:
            d_x = _as_grad(BsrTranspose(data, cols, x.shape[0] // C)(g), x)
        return d_data, None, d_x


def bsr_spmm(data, cols, x):
    """K12: ``Y = A X``, ``x`` of shape ``(nbcols * C, k)``, ``Y`` of shape
    ``(nbrows * R, k)`` in ``promote_types(data, x)``.  :func:`k12_streamed`
    says which of the two kernels a call takes; ``K12_PATHS`` counts them.
    Differentiable in ``data`` on both devices and in ``x`` on the CPU; on
    the card an ``x`` that requires a gradient raises."""
    if _wants_grad(data, x):
        if x.requires_grad and not _on_cpu(data, cols, x):
            raise NotImplementedError(
                "bsr_spmm: no gradient to X on the card; differentiate a solve "
                "through b with krylov_tpu_torch.diffable.solve")
        return _BsrSpmm.apply(data, cols, x)
    return _bsr_spmm(data, cols, x)


def _bsr_spmm(data, cols, x):
    """K12's launch, or its plain version for CPU tensors."""
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
    streamed = k12_streamed(dt, C, k, [t.data_ptr() for t in (data, x, y)])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.krylov_bsr_spmm(_CODES[dt], int(streamed), _ptr(data), _ptr(cols), _ptr(x),
                                  _ptr(y), nbrows, max_blocks, R, C, k, _stream(x))
    _check(lib, err, "bsr_spmm")
    _count(LAUNCHES, "bsr_spmm")
    _count(K12_PATHS, "streamed" if streamed else "general")
    return y
