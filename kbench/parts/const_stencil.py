"""Operator kind ``const_stencil``: a constant-coefficient stencil on the
configuration's ``grid``, with its ``offsets`` and ``weights``."""

from kbench.reference.stencil import ConstStencil


def port(kt, cfg, dtype, device):
    """The port's operator: ``ops.ConstStencilOperator`` (K2 on the card)."""
    return kt.ops.ConstStencilOperator(cfg["grid"], cfg["offsets"], cfg["weights"],
                                       dtype=dtype, device=device)


def reference(cfg, dtype, device):
    return ConstStencil(cfg["grid"], cfg["offsets"], cfg["weights"], dtype, device)
