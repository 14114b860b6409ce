"""Solve-result reporting.

The same six-field namedtuple as ``krylov_tpu._info.Info``: ``success`` is a
plain bool, ``numsteps`` a plain int, ``resnorms`` a host numpy array of
shape ``(numsteps + 1, *rhs)`` and ``xk`` a tensor on the solve's device.
"""

from collections import namedtuple

Info = namedtuple(
    "IterInfo",
    ["success", "xk", "numsteps", "resnorms", "num_operations", "arnoldi"],
    defaults=(None, None),
)
