"""Build the hand-written CUDA kernels at first use.

``build()`` compiles each ``krylov_tpu_torch/csrc/*.cu`` with its own
``nvcc``, all started together, and links the objects into one shared
library with a plain C interface, named by a hash of the sources and flags,
under ``krylov_tpu_torch/_build/`` (listed in ``.gitignore``).  A library of
the same hash is reused, so an edited source rebuilds and an unchanged one
does not.  Nothing but the package's own sources goes in.

The target is Hopper, ``sm_90a``.  ``nvcc`` is taken from ``$CUDA_HOME``,
then ``PATH``, then the toolkit's default install location.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc():
    home = os.environ.get("CUDA_HOME")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path(defines=()):
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkrylov_kernels_{digest.hexdigest()[:16]}.so"


def build(defines=()):
    """Compile the kernels unless they are built already.

    ``defines``: ``NAME=value`` macros that override the sources' tuning
    constants (a sweep builds one library per variant; the package itself
    builds with none).  Returns ``(path, seconds, log)``: the library, the
    compile time (0.0 when reused) and nvcc's output, which lists each
    kernel's registers, shared memory and spills.
    """
    path = library_path(defines)
    log_path = path.with_suffix(".log")
    if path.exists():
        return path, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    tmp = path.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = "", False
    for _, proc in jobs:
        log += proc.communicate()[0]
        failed |= proc.returncode != 0
    objs = [obj for obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds, log


@functools.cache
def load():
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build()[0]))
