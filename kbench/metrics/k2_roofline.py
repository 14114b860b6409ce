"""K2's share of its bandwidth bound, in %: the bytes of its calls by the
frozen byte model (x read, y written: 2 N words a call) at the card's
published bandwidth, over K2's device time by kernel name.  Read only
where every K2 call is at the configuration's own grid: a constant
stencil and no preconditioner (a V-cycle's coarse levels would run K2 at
other sizes)."""

from kbench.harness.models import matvec_bytes, peak_gbps, roofline_percent

K2_KERNELS = ("const_stencil2d_kernel", "const_stencil2d_tiled_kernel")


def read(run):
    if run.trace is None or run.cfg["operator"] != "const_stencil" or run.wl.get("precond"):
        return None
    gbps = peak_gbps(run.card)
    rows = [v for k, v in run.trace.kernels.items() if any(n in k for n in K2_KERNELS)]
    seconds, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if gbps is None or count == 0 or seconds <= 0:
        return None
    nbytes = count * run.wl["rhs"] * matvec_bytes("const_stencil", run.n, run.itemsize)
    return roofline_percent(nbytes, seconds, gbps)
