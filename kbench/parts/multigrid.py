"""Preconditioner kind ``multigrid``: the geometric V-cycle, its ``args``
(``smooth``, ``omega``, ``n_levels``, ``coarse_iters``) as the port's
``MultigridPreconditioner`` takes them."""

from kbench.reference.multigrid import VCycle


def port(kt, A, args):
    return kt.MultigridPreconditioner(A, **args)


def reference(A_ref, args):
    return VCycle(A_ref, **args)
