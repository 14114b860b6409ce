"""The port's device rule: the CUDA device unless the caller asks for the
CPU.

The other CPU test files call ``set_default_device("cpu")`` when they are
imported, so the rule with nothing set is exercised in fresh interpreters:
on a machine without a CUDA device, inputs that carry no device raise a
``RuntimeError`` naming ``set_default_device``; after
``set_default_device("cpu")`` they run on the CPU; and a solve given only
CPU tensors needs no default at all.
"""

import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import krylov_tpu_torch as kt
from krylov_tpu_torch import _device

torch.set_num_threads(1)
kt.set_default_device("cpu")  # these tests run on the CPU

PRELUDE = (
    "import numpy as np, scipy.sparse, torch\n"
    "import krylov_tpu_torch as kt\n"
    "assert not torch.cuda.is_available()\n"
)

# one line each: an entry point given nothing that carries a device
DEVICELESS = {
    "poisson_2d": "kt.ops.stencil.poisson_2d(8)",
    "poisson_1d": "kt.ops.stencil.poisson_1d(8)",
    "diffusion_2d": "kt.ops.stencil.diffusion_2d(np.ones((4, 4)))",
    "poisson_2d_const": "kt.poisson_2d_const(8)",
    "cg_dense": "kt.cg(np.eye(3), np.ones(3))",
    "cg_scipy": "kt.cg(scipy.sparse.identity(3, format='csr'), np.ones(3))",
    "qmr_dense": "kt.qmr(np.eye(3), np.ones(3))",
    "lsqr_dense": "kt.lsqr(np.eye(3), np.ones(3))",
    "as_operator_scipy": "kt.as_operator(scipy.sparse.identity(3, format='csr'))",
    "as_operator_ndarray": "kt.as_operator(np.eye(3))",
    "csr_from_scipy": "kt.ops.sparse.CSROperator.from_scipy(scipy.sparse.identity(3))",
    "bsr_from_scipy": "kt.ops.bsr.BSROperator.from_scipy(scipy.sparse.identity(4), 2)",
    "default_device": "kt.default_device()",
}


def _run(code):
    return subprocess.run([sys.executable, "-c", PRELUDE + code], capture_output=True,
                          text=True, timeout=120)


@functools.cache
def _deviceless_outcomes():
    """Every DEVICELESS call in one fresh interpreter (importing torch
    dominates a subprocess): name -> "RAISED", or what happened instead."""
    code = "import json\nout = {}\n"
    for name, call in DEVICELESS.items():
        code += (
            "try:\n"
            f"    {call}\n"
            f"    out[{name!r}] = 'ran on the CPU unasked'\n"
            "except RuntimeError as e:\n"
            f"    out[{name!r}] = 'RAISED' if 'set_default_device(\"cpu\")' in str(e) else str(e)\n"
        )
    proc = _run(code + "print(json.dumps(out))\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(DEVICELESS))
def test_no_device_and_nothing_set_raises(name):
    """Without a CUDA device and without ``set_default_device`` the call
    raises and names the way out; it does not carry on on the CPU."""
    assert _deviceless_outcomes()[name] == "RAISED"


def test_import_needs_no_device():
    proc = _run("import krylov_tpu_torch.convert, krylov_tpu_torch.multigrid\nprint('OK')\n")
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


def test_after_asking_for_the_cpu_everything_runs_there():
    proc = _run(
        "kt.set_default_device('cpu')\n"
        "A = kt.ops.stencil.poisson_2d(8)\n"
        "assert A.coeffs.device.type == 'cpu'\n"
        "x, info = kt.cg(np.eye(3), np.ones(3))\n"
        "assert info.success and x.device.type == 'cpu'\n"
        "x, info = kt.cg_stencil(A, np.ones(A.grid), tol=1e-8)\n"
        "assert info.success and x.device.type == 'cpu'\n"
        "x, info = kt.bicgstab(scipy.sparse.identity(3, format='csr'), np.ones(3))\n"
        "assert info.success and x.device.type == 'cpu'\n"
        "assert kt.default_device() == torch.device('cpu')\n"
        "print('OK')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stdout + proc.stderr


def test_cpu_tensors_need_no_default():
    """A solve given only tensors runs where they lie; nothing asks for the
    default device."""
    proc = _run(
        "x, info = kt.cg(torch.eye(3), torch.ones(3))\n"
        "assert info.success and x.device.type == 'cpu'\n"
        "x, info = kt.gmres(torch.eye(3).double(), torch.ones(3).double())\n"
        "assert info.success\n"
        "A = kt.ops.stencil.poisson_2d(4, device='cpu')\n"
        "x, info = kt.cg_stencil(A, np.ones(A.grid))\n"  # b goes to A.device
        "assert info.success and x.device.type == 'cpu'\n"
        "x, info = kt.qmr(A, np.ones(16), tol=1e-8)\n"
        "assert info.success and x.device.type == 'cpu'\n"
        "print('OK')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stdout + proc.stderr


def test_resolution_rules():
    """``as_tensor`` keeps a tensor where it lies and sends the rest to the
    named device; ``device_of`` reads an operator's device."""
    t = torch.ones(2)
    assert _device.as_tensor(t, "meta") is t
    assert _device.as_tensor([1.0, 2.0], "meta").device.type == "meta"
    assert _device.as_tensor(np.ones(2)).device.type == "cpu"
    assert _device.resolve("meta") == torch.device("meta")
    assert _device.device_of(kt.MatrixOperator(torch.ones(2, 2, device="meta"))).type == "meta"
    assert _device.device_of(np.eye(2)) is None


def test_deviceless_inputs_follow_the_operator():
    """A numpy right-hand side goes to the operator's device, not to the
    default one; an operator and a tensor on different devices are not
    moved together silently."""
    A = kt.MatrixOperator(torch.eye(3, device="meta"))
    with pytest.raises(Exception):  # the meta device computes nothing to read back
        kt.cg(A, np.ones(3, np.float32))
    from krylov_tpu_torch.solvers._common import setup

    _, b, x0, *_ = setup(A, np.ones(3, np.float32))
    assert b.device.type == "meta" and x0.device.type == "meta"
    # a CPU tensor b with an operator elsewhere stays where it is
    _, b, *_ = setup(A, torch.ones(3))
    assert b.device.type == "cpu"
    sp = scipy.sparse.identity(3, format="csr")
    assert kt.as_operator(sp, device="cpu").device.type == "cpu"
