"""The yardstick: published peaks and the byte models of one operator
product, frozen here so that a later change to the port cannot move them.

``PEAK_GBPS`` is the port's ``profiling.PEAK_GBPS`` and
:func:`matvec_bytes` its ``profiling.spmv_traffic_model``, as they stood
when the benchmark was defined, written over sizes instead of the port's
objects.
"""

# published memory bandwidth in GB/s, by the name torch.cuda.get_device_name gives
PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # NVIDIA H100 datasheet, SXM5: 3.35 TB/s
    "NVIDIA H100 PCIe": 2000.0,  # NVIDIA H100 datasheet, PCIe: 2 TB/s
    "NVIDIA H200": 4800.0,  # NVIDIA H200 datasheet, SXM: 4.8 TB/s
}


def peak_gbps(card):
    """The card's published bandwidth: its entry, else the longest entry
    its name starts with; None for a card the table does not know."""
    if card in PEAK_GBPS:
        return PEAK_GBPS[card]
    known = [k for k in PEAK_GBPS if card.startswith(k)]
    return PEAK_GBPS[max(known, key=len)] if known else None


def matvec_bytes(kind, n, itemsize, *, nnz=0, ndiag=0, index_bytes=4):
    """Ideal device-memory bytes of one ``A @ x`` with ``n`` rows:

    * ``const_stencil``: x read and y written (the weights are constants);
    * ``grid_stencil``: the ``ndiag`` coefficient planes, x and y;
    * ``csr``: values and column indices of the ``nnz`` entries, x once, y;
    * ``dense``: the matrix, x and y.
    """
    if kind == "const_stencil":
        return 2 * n * itemsize
    if kind == "grid_stencil":
        return (ndiag + 2) * n * itemsize
    if kind == "csr":
        return nnz * (itemsize + index_bytes) + 2 * n * itemsize
    if kind == "dense":
        return (n * n + 2 * n) * itemsize
    raise ValueError(f"no byte model for {kind!r}")


def roofline_percent(nbytes, seconds, gbps):
    """The share of the bandwidth bound, in %: the least time ``nbytes``
    take at ``gbps`` over the ``seconds`` measured."""
    return 100.0 * nbytes / (gbps * 1e9) / seconds
