"""Analysis utilities (counterpart of ``krylov_tpu.utils``): custom-inner
QR, principal angles between subspaces, the Hegedüs initial-guess
rescaling, the Strakoš test matrix, spectral gaps, the overflow-safe
normalized-roots polynomial, and a Lanczos estimate of a spectrum's ends.

QR and angles run on the tensors' own device (``torch.linalg.qr`` /
``torch.linalg.svd``); the polynomial root utilities stay host-side numpy:
they are analysis-only and never sit on a hot path.
"""

import numpy as np
import torch

from . import _device
from .errors import ArgumentError

__all__ = [
    "qr",
    "angles",
    "hegedus",
    "strakos",
    "gap",
    "NormalizedRootsPolynomial",
    "estimate_spectrum",
]


def _scalar(v, like):
    """An inner-product value as a 0-d tensor on ``like``'s device."""
    return torch.as_tensor(v, device=like.device).reshape(())


def qr(X, inner=None, reorthos: int = 1):
    """QR factorization with a customizable inner product.

    With the default (Euclidean) inner product this defers to
    ``torch.linalg.qr``.  With a custom inner it runs left-looking modified
    Gram-Schmidt with ``reorthos`` refinement passes per column: each pass
    re-projects the column against every finished basis vector and folds the
    measured coefficients back into R, so R stays the exact factor of the
    *performed* transformation regardless of how many passes run.

    :param X: tensor (or array) with ``shape == (N, k)``.
    :param reorthos: extra orthogonalization passes per column (default 1,
        i.e. MGS2).
    :return: ``(Q, R)`` with ``<Q, Q> = I_k`` and R upper triangular.
    """
    X = _device.as_tensor(X)
    n, k = X.shape
    if k == 0:
        return X, torch.zeros((0, 0), dtype=X.dtype, device=X.device)
    if inner is None:
        return torch.linalg.qr(X, mode="reduced")

    basis = []   # finished orthonormal columns, each (n, 1)
    r_cols = []  # matching columns of R, each (k,)
    for i in range(k):
        v = X[:, i : i + 1]
        coeff = torch.zeros((k,), dtype=X.dtype, device=X.device)
        for _ in range(reorthos + 1):
            for j, qj in enumerate(basis):
                c = _scalar(inner(qj, v), X).to(X.dtype)
                v = v - c * qj
                coeff[j] += c
        nrm2 = _scalar(inner(v, v), X)
        # <v, v> is real non-negative up to roundoff; |.| guards the sqrt
        nrm = torch.sqrt(torch.abs(nrm2)).to(X.dtype)
        # a (numerically) zero column stays unnormalized: R records 0 and
        # downstream consumers see an exactly reproducible X = Q R
        keep = torch.abs(nrm) >= 1e-15
        basis.append(torch.where(keep, v / torch.where(keep, nrm, 1.0), v))
        coeff[i] = nrm
        r_cols.append(coeff)
    return torch.cat(basis, dim=1), torch.stack(r_cols, dim=1)


def angles(F, G, inner=None, compute_vectors: bool = False):
    """Principal angles between ``range(F)`` and ``range(G)``.

    Implements the sine/cosine split of Knyazev & Argentati, *Principal
    angles between subspaces in an A-based scalar product* (SIAM J. Sci.
    Comput. 23(6), 2002), alg. 6.2, for any (possibly weighted) inner
    product.  ``theta`` ascending of length ``max(dim F, dim G)``, padded
    with ``pi/2``; with ``compute_vectors=True`` also principal vectors
    ``U, V`` satisfying ``<U, V> = diag(cos(theta))``.

    Method: after orthonormalizing both bases, the SVD
    ``<QF, QG> = Y diag(sigma) Z^H`` yields cosines, accurate only for
    angles above pi/4.  For the ``ns`` angles below pi/4 (``sigma^2 >=
    1/2``) the sines are recomputed from the component of the G-side
    principal vectors orthogonal to ``range(F)``; in exact arithmetic
    ``<B, B> = I - diag(sigma^2)``, so the SVD of its triangular factor
    returns ``sin(theta)`` to full *relative* accuracy where
    ``1 - sigma^2`` would lose every digit.
    """
    F = _device.as_tensor(F)
    G = _device.as_tensor(G, F.device)

    # orient so F spans the larger space; undo on the vectors at the end
    swapped = F.shape[1] < G.shape[1]
    if swapped:
        F, G = G, F
    p, q = F.shape[1], G.shape[1]

    if inner is None:
        def ip(x, y):
            return x.mH @ y
    else:
        def ip(x, y):
            return torch.as_tensor(inner(x, y), device=F.device)

    QF, _ = qr(F, inner=inner)
    QG, _ = qr(G, inner=inner)
    real = QF.real.dtype
    half_pi = torch.pi / 2

    if q == 0:
        theta = torch.full((p,), half_pi, dtype=real, device=F.device)
        U, V = QF, QG
    else:
        # cosine pass: sigma descending, so the small angles come first
        Y, sigma, Zh = torch.linalg.svd(ip(QF, QG))
        Z = Zh.mH
        ns = int(torch.count_nonzero(sigma ** 2 >= 0.5))
        # the dense principal-vector products are O(n p^2): only the ns
        # small-angle G-side columns are needed for the sine pass; the
        # full U/V pair is built on request alone
        if compute_vectors:
            U = QF @ Y                  # (n, p) F-side principal vectors
            V = QG @ Z                  # (n, q) G-side principal vectors
        theta = torch.cat([
            torch.acos(torch.clamp(sigma[ns:], -1.0, 1.0)),
            torch.full((p - q,), half_pi, dtype=sigma.dtype, device=F.device),
        ])

        if ns > 0:
            # sine pass over the first ns pairs
            Vs = V[:, :ns] if compute_vectors else QG @ Z[:, :ns]
            B = Vs - QF @ ip(QF, Vs)    # G-side component outside range(F)
            _, Rb = qr(B, inner=inner)
            _, mu, Zbh = torch.linalg.svd(Rb)
            mu = mu.flip(0)             # ascending, pairs with theta order
            theta = torch.cat([torch.asin(torch.clamp(mu, -1.0, 1.0)), theta])
            if compute_vectors:
                # Re-pair the vectors under the sine-based rotation Zb
                # (columns reversed to match the ascending angles):
                #   V_small <- Vs Zb.
                # The F side rotates compatibly with
                #   Mrot = diag(sigma_s) Zb diag(1/cos(theta_s)),
                # unitary because Zb^H diag(sigma_s^2) Zb =
                # diag(cos^2 theta_s) in exact arithmetic; it maps
                # <U_s, Vs> = diag(sigma_s) onto diag(cos theta_s), the
                # cosines evaluated from mu (cos = sqrt(1 - mu^2) keeps
                # full accuracy here since theta_s < pi/4).
                Zb = Zbh.mH.flip(1)
                cos_s = torch.sqrt(1.0 - torch.clamp(mu, 0.0, 1.0) ** 2)
                Mrot = (sigma[:ns, None] * Zb) / cos_s[None, :]
                U = torch.cat([U[:, :ns] @ Mrot, U[:, ns:]], dim=1)
                V = torch.cat([Vs @ Zb, V[:, ns:]], dim=1)

    if compute_vectors:
        if swapped:
            U, V = V, U
        return theta, U, V
    return theta


def hegedus(A, b, x0, M=None, Ml=None, inner=None):
    """Rescale an initial guess to minimize the initial residual.

    The Hegedüs trick: over the one-parameter family ``gamma * x0`` the
    preconditioned residual norm ``|| Ml (b - gamma A x0) ||_M`` is a
    quadratic in ``gamma``; its minimizer is the Galerkin coefficient

        ``gamma = <M Ml A x0, Ml b> / <M Ml A x0, Ml A x0>``.

    Costs one matvec and removes the worst-case factor-2 overhead of a
    badly scaled ``x0``.  When ``A x0`` is numerically zero the scale is
    irrelevant and the zero vector (exact minimizer of the family) is
    returned.
    """
    from ._inner import as_inner

    b = _device.as_tensor(b, _device.device_of(A))
    x0 = _device.as_tensor(x0, b.device)
    ip = as_inner(inner, b.shape)

    def apply(op, v):
        return v if op is None else op @ v

    w = apply(Ml, A @ x0)
    Mw = apply(M, w)
    denom = ip(Mw, w)  # squared (M, Ml)-seminorm of A @ x0
    if not bool(torch.any(denom.real > 1e-15)):
        return torch.zeros_like(x0)
    gamma = ip(Mw, apply(Ml, b)) / denom
    return gamma * x0


def strakos(n, l_min=0.1, l_max=100, rho=0.9, device=None):
    """The Strakoš test matrix, on ``device`` (the default device when
    None)."""
    d = [
        l_min + (i - 1) * 1.0 / (n - 1) * (l_max - l_min) * (rho ** (n - i))
        for i in range(1, n + 1)
    ]
    return torch.diag(torch.as_tensor(d, dtype=torch.float64, device=_device.resolve(device)))


def _host(a):
    """``a`` as a host ndarray (a tensor is copied from its device)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def gap(lamda, sigma, mode: str = "individual"):
    """Spectral gap between two sets of real eigenvalue estimates.

    ``individual``: smallest pairwise distance between the two sets.
    ``interval``: distance from the interval hull of ``lamda`` to the
    nearest element of ``sigma`` outside it; ``None`` if any element of
    ``sigma`` falls strictly inside the hull.
    """
    lamda = np.atleast_1d(_host(lamda))
    sigma = np.atleast_1d(_host(sigma))
    if np.iscomplexobj(lamda) and lamda.imag.any() or (
        np.iscomplexobj(sigma) and sigma.imag.any()
    ):
        raise ArgumentError("complex spectra not yet implemented")
    lamda, sigma = lamda.real, sigma.real

    if mode == "individual":
        return float(np.abs(np.subtract.outer(lamda, sigma)).min())
    if mode == "interval":
        lo, hi = lamda.min(), lamda.max()
        inside = (sigma > lo) & (sigma < hi)
        if inside.any():
            return None
        below = np.where(sigma <= lo, lo - sigma, np.inf).min()
        above = np.where(sigma >= hi, sigma - hi, np.inf).min()
        return float(min(below, above))
    raise ArgumentError(f"unknown mode {mode!r}")


class NormalizedRootsPolynomial:
    r"""Polynomial with prescribed roots and p(0) = 1:

    .. math:: p(\lambda) = \prod_i (1 - \lambda / \theta_i)

    A naive left-to-right product over thousands of factors can overflow or
    underflow long before the (moderate) final value; evaluation therefore
    pairs each large-magnitude factor with a small one before multiplying.
    This is done fully vectorized: factors are sorted by magnitude along
    the root axis and re-rows with one fixed interleaving permutation, so a
    whole batch of points evaluates with no per-point Python loop.  Host
    numpy throughout.
    """

    def __init__(self, roots):
        roots = _host(roots)
        if roots.ndim != 1:
            raise ArgumentError("one-dimensional array of roots expected.")
        self.roots = roots
        # fixed interleaving: positions 0,2,4,.. take the smallest factors
        # in ascending order, 1,3,5,.. the largest in descending order
        n = roots.shape[0]
        half = (n + 1) // 2
        self._interleave = np.empty(n, dtype=int)
        self._interleave[0::2] = np.arange(half)
        self._interleave[1::2] = np.arange(n - 1, half - 1, -1)

    def minmax_candidates(self):
        """Points where the derivative vanishes (for extrema over intervals)."""
        from numpy.polynomial import Polynomial as P

        return P.fromroots(self.roots).deriv(1).roots()

    def __call__(self, points):
        pts = _host(points)
        if pts.ndim > 1:
            raise ArgumentError(
                "scalar or one-dimensional array of points expected."
            )
        factors = 1.0 - np.atleast_1d(pts)[None, :] / self.roots[:, None]
        order = np.argsort(np.abs(factors), axis=0)[self._interleave]
        out = np.prod(np.take_along_axis(factors, order, axis=0), axis=0)
        return out.item() if pts.ndim == 0 else out


def estimate_spectrum(A, n=None, iters=30, safety=1.05, seed=0, M=None, device=None):
    """Estimate the extreme eigenvalues of a Hermitian operator.

    Runs ``iters`` steps of the Lanczos process (the same recurrence the
    solvers use) and returns ``(lmin / safety, lmax * safety)`` from the
    Ritz values of the tridiagonal section: widened bounds suitable as
    ``chebyshev(..., eigenvalue_estimates=...)`` and as the interval of a
    :class:`~krylov_tpu_torch.ChebyshevPreconditioner`.

    The start vector is drawn on the host from
    ``numpy.random.default_rng(seed)``, as the reference draws it (the same
    seed starts both packages from the same vector), in float64, cast to
    the operator's floating type where it names one, and placed on the
    operator's device, else on ``device`` (the default device when None).
    ``n`` (matrix dimension) is needed only when ``A`` does not expose
    ``shape``.
    """
    from ._operators import as_operator
    from .arnoldi import ArnoldiLanczos

    dim = A.shape[0] if hasattr(A, "shape") else n
    if dim is None:
        raise ArgumentError("pass n= for operators without .shape")
    rng = np.random.default_rng(seed)
    dev = _device.device_of(A)
    v0 = torch.as_tensor(rng.standard_normal(dim),
                         device=_device.resolve(device) if dev is None else dev)
    dt = getattr(A, "dtype", None)
    if isinstance(dt, torch.dtype) and dt.is_floating_point:
        v0 = v0.to(dt)
    it = ArnoldiLanczos(as_operator(A, v0.device), v0, M=M)
    alphas, betas = [], []
    for _ in range(min(iters, dim)):
        if it.is_invariant:
            break
        _, h, _ = next(it)
        alphas.append(float(h[1].real))
        betas.append(float(h[2].real))
    k = len(alphas)
    T = np.diag(alphas)
    for i in range(k - 1):
        T[i, i + 1] = T[i + 1, i] = betas[i]
    ritz = np.linalg.eigvalsh(T)
    lmin, lmax = float(ritz[0]), float(ritz[-1])
    # Lanczos converges to extreme eigenvalues from the inside: widen
    lo = lmin / safety if lmin > 0 else lmin * safety
    return lo, lmax * safety
