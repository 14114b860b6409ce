"""Build the hand-written CUDA kernels at first use.

``build()`` compiles ``krylov_tpu_torch/csrc/*.cu`` with ``nvcc`` into one
shared library with a plain C interface, named by a hash of the sources and
flags, under ``krylov_tpu_torch/_build/`` (listed in ``.gitignore``).  A
library of the same hash is reused, so an edited source rebuilds and an
unchanged one does not.  Nothing but the package's own sources goes in.

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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkrylov_kernels_{digest.hexdigest()[:16]}.so"


def build():
    """Compile the kernels unless they are built already.

    Returns ``(path, seconds, log)``: the library, the compile time (0.0
    when reused) and nvcc's output, which lists each kernel's registers,
    shared memory and spills.
    """
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        return path, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds, log


@functools.cache
def load():
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build()[0]))
