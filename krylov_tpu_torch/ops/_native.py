"""Native (C++) host set-up of the sparse preconditioners, with the numpy
versions as fallback and ground truth.

Counterpart of the AMG and ILU half of ``krylov_tpu.ops._native``.  The
sources in ``krylov_tpu_torch/csrc/host/`` are the reference package's
set-up sources copied byte for byte, so both packages build the same
hierarchies and factors (the port reads no file of the reference):

* ``amg_agg.cpp``: one pass of AMG's strongest-neighbour pairwise matching,
  label-identical to ``amg._pairwise_labels``;
* ``amg_rap.cpp``: the smoothed-aggregation Galerkin product ``P^H A P``;
* ``ilu0.cpp``: the ILU(0) numeric phase and the dependency levels of a
  triangular factor.

Each source is compiled at first use with ``g++`` into
``krylov_tpu_torch/_build/`` (gitignored), named by a hash of the source and
its flags, and loaded with ctypes.  Where no ``g++`` is found, a build
fails, or ``KRYLOV_TORCH_NO_NATIVE`` is set (read at every call), a helper
returns None and its caller takes the numpy path.  ``NATIVE_PATHS[helper]``
counts the calls by the route they took, ``"native"`` or ``"numpy"``.

This is host code: no helper touches a device.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import sys

import numpy as np

from .._build import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
_COMMON_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# -ffp-contract=off: the matching's sort key must be bit-identical to
# numpy's (no FMA fusion of its final multiply-subtract), or labels differ
_FLAGS = {
    "amg_agg": ("-ffp-contract=off",) + _COMMON_FLAGS,
    "amg_rap": _COMMON_FLAGS,
    "ilu0": _COMMON_FLAGS,
}

NATIVE_PATHS = {
    name: {"native": 0, "numpy": 0}
    for name in ("amg_pairwise_labels", "amg_rap", "ilu0_factor", "tri_levels")
}


def reset_native_paths():
    for routes in NATIVE_PATHS.values():
        for route in routes:
            routes[route] = 0


def _counted(name, out):
    NATIVE_PATHS[name]["numpy" if out is None else "native"] += 1
    return out


def build_host(stem):
    """Compile ``csrc/host/<stem>.cpp`` unless it is built already; returns
    the shared library's path."""
    flags = _FLAGS[stem]
    src = HOST_SRC / f"{stem}.cpp"
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(src.read_bytes())
    path = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.so.tmp")
        subprocess.run(["g++", *flags, str(src), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
# allocator callback of amg_rap: Python hands out zeroed numpy buffers the
# kernel fills
_ALLOC_FN = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32)
_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {  # each library's C entry points: argument types
    "amg_agg": {"amg_pairwise_labels": [_i64, _vp, _vp, _i32, _vp, _i32, ctypes.c_double,
                                        _i64, _I64P]},
    "amg_rap": {"amg_rap": [_i64, _vp, _vp, _i32, _vp, _i32, _I64P, _i64, _F64P, _ALLOC_FN,
                            _I64P]},
    "ilu0": {"ilu0_factor": [_i64, _I64P, _I64P, _F64P],
             "tri_levels": [_i64, _I64P, _I64P, _i64, _I64P]},
}


@functools.cache
def _built(stem):
    """The loaded library of ``stem``, or None when it cannot be built."""
    try:
        lib = ctypes.CDLL(str(build_host(stem)))
    except (OSError, subprocess.CalledProcessError) as e:  # no g++, a failed build
        detail = getattr(e, "stderr", b"") or b""
        sys.stderr.write(f"krylov_tpu_torch: native {stem} unavailable ({e!r} "
                         f"{detail.decode(errors='replace')[:400]}); using the numpy "
                         "set-up path\n")
        return None
    for name, argtypes in _SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int64, argtypes
    return lib


def _load(stem):
    if os.environ.get("KRYLOV_TORCH_NO_NATIVE"):
        return None
    return _built(stem)


def _index_arrays(csr):
    """scipy's int32 index arrays as they are (kind 0), anything else as
    int64 (kind 1): the kernels dispatch on the kind, so no O(nnz) copy."""
    if csr.indptr.dtype == np.int32 and csr.indices.dtype == np.int32:
        return np.ascontiguousarray(csr.indptr), np.ascontiguousarray(csr.indices), 0
    return (np.ascontiguousarray(csr.indptr, dtype=np.int64),
            np.ascontiguousarray(csr.indices, dtype=np.int64), 1)


def _data_kind(csr):
    return {np.dtype(np.float32): 0, np.dtype(np.float64): 1}.get(np.dtype(csr.dtype))


# ---- amg_agg.cpp: AMG pairwise-matching aggregation -----------------------


def amg_pairwise_labels_native(csr, theta, rounds=8):
    """Native twin of ``amg._pairwise_labels`` (label-identical).  ``csr``
    must be canonical (sorted indices, no duplicates); returns ``(labels,
    n_agg)``, or None where the native path is unavailable, the dtype is
    not float32/float64, or the indices are unsorted."""
    return _counted("amg_pairwise_labels", _pairwise_labels(csr, theta, rounds))


def _pairwise_labels(csr, theta, rounds):
    kind, lib = _data_kind(csr), _load("amg_agg")
    if lib is None or kind is None or not csr.has_sorted_indices:
        return None
    indptr, indices, idx_kind = _index_arrays(csr)
    data = np.ascontiguousarray(csr.data)
    labels = np.empty(csr.shape[0], dtype=np.int64)
    n_agg = lib.amg_pairwise_labels(
        csr.shape[0], indptr.ctypes.data, indices.ctypes.data, idx_kind, data.ctypes.data,
        kind, float(theta), int(rounds),
        labels.ctypes.data_as(_I64P))
    return None if n_agg < 0 else (labels, int(n_agg))


# ---- amg_rap.cpp: smoothed-aggregation Galerkin triple product ------------


def amg_rap_native(csr, labels, n_agg, scale=None):
    """Native Galerkin product ``P^H A P`` with the smoothed-aggregation
    prolongator ``P = P_hat - diag(scale) (A P_hat)`` (``scale=None``: the
    tentative ``P_hat`` itself, a relabel-and-sum).

    ``csr`` must be canonical real float32/float64 CSR.  Returns the coarse
    matrix as a scipy CSR in ``csr.dtype`` with sorted indices, or None
    where the native path is unavailable (complex matrices take the scipy
    path in ``amg._smoothed_prolongator``)."""
    return _counted("amg_rap", _galerkin(csr, labels, n_agg, scale))


def _galerkin(csr, labels, n_agg, scale):
    kind, lib = _data_kind(csr), _load("amg_rap")
    if lib is None or kind is None:
        return None
    import scipy.sparse

    indptr, indices, idx_kind = _index_arrays(csr)
    data = np.ascontiguousarray(csr.data)
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    scale64 = None if scale is None else np.ascontiguousarray(scale, dtype=np.float64)
    bufs = {}

    @_ALLOC_FN
    def _alloc(nbytes, which):
        a = np.zeros(int(nbytes), np.uint8)
        bufs[int(which)] = a  # kept alive until the kernel returns
        return a.ctypes.data

    nnz = ctypes.c_int64()
    rc = lib.amg_rap(
        csr.shape[0], indptr.ctypes.data, indices.ctypes.data, idx_kind, data.ctypes.data,
        kind, labels64.ctypes.data_as(_I64P), int(n_agg),
        None if scale64 is None else scale64.ctypes.data_as(_F64P),
        _alloc, ctypes.byref(nnz))
    if rc != 0:
        return None
    nnz = int(nnz.value)
    Ac = scipy.sparse.csr_matrix(
        (bufs[2].view(np.float64)[:nnz].astype(csr.dtype), bufs[1].view(np.int32)[:nnz],
         bufs[0].view(np.int64)),
        shape=(int(n_agg), int(n_agg)))
    Ac.has_sorted_indices = True  # the kernel emits each row sorted
    return Ac


# ---- ilu0.cpp: ILU(0) numerics and dependency levels ----------------------


def _int64_csr(csr):
    """int64 row pointers and columns (the ILU kernels' only index type),
    with pointers to them; the arrays are returned to stay alive."""
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int64)
    return indptr, indices, indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I64P)


def ilu0_factor_native(csr):
    """In-place ILU(0) numerics on a canonical CSR (sorted indices): the
    factored ``data`` in float64, or None where the native path is
    unavailable or the matrix is complex (the kernel is real float64)."""
    return _counted("ilu0_factor", _ilu0(csr))


def _ilu0(csr):
    lib = _load("ilu0")
    if lib is None or np.iscomplexobj(csr.data):
        return None
    indptr, indices, p_indptr, p_indices = _int64_csr(csr)
    data = np.array(csr.data, dtype=np.float64)  # a copy: factored in place
    rc = lib.ilu0_factor(csr.shape[0], p_indptr, p_indices, data.ctypes.data_as(_F64P))
    return data if rc == 0 else None


def tri_levels_native(sp_csr, lower):
    """Dependency level of each row of a triangular factor (row ``i`` is in
    level ``1 + max(level of its strictly lower, or upper, neighbours)``) as
    an int64 array, or None where the native path is unavailable.  One
    sequential pass over the entries."""
    return _counted("tri_levels", _levels(sp_csr, lower))


def _levels(sp_csr, lower):
    lib = _load("ilu0")
    if lib is None:
        return None
    indptr, indices, p_indptr, p_indices = _int64_csr(sp_csr)
    level = np.zeros(sp_csr.shape[0], dtype=np.int64)
    lib.tri_levels(sp_csr.shape[0], p_indptr, p_indices, 1 if lower else 0,
                   level.ctypes.data_as(_I64P))
    return level
