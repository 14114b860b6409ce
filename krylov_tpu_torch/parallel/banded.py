"""Row-partitioned banded (stencil) operator with halo exchange.

Counterpart of ``krylov_tpu.parallel.banded``: the distributed analogue of
:class:`krylov_tpu_torch.ops.stencil.BandedOperator`.  Each rank owns a
contiguous slab of rows; row ``i`` reads ``x[i + offset]`` for each stored
band, so a rank needs ``max(-min(offsets), 0)`` entries from its previous
neighbour and ``max(max(offsets), 0)`` from its next one.  Those halos
travel as one exchange (:meth:`Mesh.start_exchange`); the ranks at the
edges of the mesh receive zeros, the Dirichlet boundary the band
coefficients already encode.  Then the matvec is the single-device
operator's sum of shifted products.

The constructor takes the local coefficient block
``coeffs[:, r0 : r0 + n_local]`` (row-aligned storage makes the partition a
plain slice along the row axis).
"""

import torch

from .mesh import ROWS


class ShardedBandedOperator:
    """Local row slab of a banded operator, with a halo-exchange matvec.

    ``coeffs`` is the local ``(ndiag, n_local)`` row-aligned block:
    ``coeffs[d, li] = A[r0 + li, r0 + li + offsets[d]]``.
    """

    def __init__(self, coeffs, offsets, mesh, axis=ROWS, hermitian=False):
        self.coeffs = coeffs
        self.offsets = tuple(int(o) for o in offsets)
        self.mesh = mesh
        self.axis = axis
        self.hermitian = bool(hermitian)

    @property
    def shape(self):
        n_local = self.coeffs.shape[1]
        return (n_local, n_local)  # the local block (square, SPMD view)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @property
    def halo(self):
        """(left, right) halo widths in rows."""
        return max(0, -min(self.offsets)), max(0, max(self.offsets))

    def exchange_halo(self, x, halo=None):
        """``x_ext = [left halo | x | right halo]`` along axis 0.

        ``halo`` overrides the matvec's widths (the adjoint needs them
        mirrored, see :meth:`rmatvec`).  Needs halo widths <= n_local
        (single-neighbour halos).
        """
        h_lo, h_hi = self.halo if halo is None else halo
        n_local = x.shape[0]
        if max(h_lo, h_hi) > n_local:
            raise ValueError(
                f"halo width {max(h_lo, h_hi)} exceeds local rows {n_local}; "
                "use fewer shards or an all-gather operator"
            )
        if not h_lo and not h_hi:
            return x
        # left halo: my previous neighbour's LAST h_lo entries; right halo:
        # my next neighbour's FIRST h_hi entries
        left, right = self.mesh.start_exchange(
            x[-h_lo:] if h_lo else None, x[:h_hi] if h_hi else None, self.axis
        ).wait()
        parts = [p for p in (left, x, right) if p is not None]
        return torch.cat(parts, dim=0)

    def _tail(self, c, x):
        return c.reshape((c.shape[0],) + (1,) * (x.ndim - 1))

    def __matmul__(self, x):
        h_lo, _ = self.halo
        n_local = x.shape[0]
        x_ext = self.exchange_halo(x)
        y = torch.zeros(x.shape, dtype=torch.promote_types(self.coeffs.dtype, x.dtype),
                        device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self._tail(self.coeffs[d], x) * x_ext[h_lo + off : h_lo + off + n_local]
        return y

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        # A^H in row-aligned banded form has bands at -off with coefficients
        # conj(coeffs[d]) shifted by off rows: the shift crosses slab
        # boundaries, so a coefficient halo travels with the x halo.  The x
        # halo widths mirror the matvec's (y[i] reads x[i - off]).
        h_lo = max(0, max(self.offsets))
        h_hi = max(0, -min(self.offsets))
        n_local = x.shape[0]
        x_ext = self.exchange_halo(x, halo=(h_lo, h_hi))
        y = torch.zeros(x.shape, dtype=torch.promote_types(self.coeffs.dtype, x.dtype),
                        device=x.device)
        for d, off in enumerate(self.offsets):
            # y[i] += conj(coeffs[d, i - off]) * x[i - off]
            c_loc = self.coeffs[d].conj()
            if off > 0:
                halo = self.mesh.shift(c_loc[-off:], +1, self.axis)
                c_ext = torch.cat([halo, c_loc[:-off]], dim=0)
            elif off < 0:
                halo = self.mesh.shift(c_loc[:-off], -1, self.axis)
                c_ext = torch.cat([c_loc[-off:], halo], dim=0)
            else:
                c_ext = c_loc
            seg = x_ext[h_lo - off : h_lo - off + n_local]
            y = y + self._tail(c_ext, x) * seg
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.coeffs[self.offsets.index(0)]
        return torch.zeros(self.coeffs.shape[1], dtype=self.dtype, device=self.device)
