"""Which device, when the caller named none.

The one place that answers it: the current CUDA device, unless the caller
asked for another with :func:`set_default_device`.  Without a CUDA device
and without that call, the first use raises; nothing carries on on the CPU
unasked.  A ``torch.Tensor`` argument always keeps its own device (passing
a CPU tensor is also asking for the CPU); numpy arrays, lists, scalars and
scipy matrices carry no device and go where :func:`resolve` says.
"""

import torch

_default = None  # the device set_default_device named, or None


def set_default_device(device):
    """Place inputs that carry no device on ``device`` from now on.

    ``set_default_device("cpu")`` is how a caller asks for the CPU;
    ``None`` restores the rule (the current CUDA device).
    """
    global _default
    _default = None if device is None else torch.device(device)


def default_device():
    """The device for inputs that carry none: the one named with
    :func:`set_default_device`, else the current CUDA device."""
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "krylov_tpu_torch runs on the CUDA device by default and found "
            "none; call krylov_tpu_torch.set_default_device(\"cpu\") (or pass "
            "CPU tensors or device=\"cpu\") to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device):
    """``device`` as a ``torch.device``; the default device for ``None``."""
    return default_device() if device is None else torch.device(device)


def as_tensor(x, device=None):
    """``x`` as a tensor.  A tensor is returned as it is, on its own
    device; anything else is placed on ``device`` (the default device for
    ``None``)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve(device))


def device_of(A):
    """The device of an operator (or tensor) that holds tensors, else None
    (a numpy array's ``device`` is a string and names no torch device)."""
    dev = getattr(A, "device", None)
    return dev if isinstance(dev, torch.device) else None
