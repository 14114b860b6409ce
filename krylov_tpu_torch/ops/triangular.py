"""Small dense triangular solves, batched over trailing right-hand-side
dimensions (counterpart of ``krylov_tpu.ops.triangular``; only
``multi_solve_triangular`` is ported so far)."""

import torch


def multi_solve_triangular(A, B, lower=False):
    """Solve ``A[:, :, t] @ y[:, t] = B[:, t]`` for every trailing index t.

    ``A`` has shape ``(k, k, *tail)``, ``B`` has ``(k, *tail)``.  Columns of
    ``B`` that are entirely zero yield zero solutions, guarding the singular
    ``R`` of already-converged right-hand-side columns, as the reference.
    """
    k = A.shape[0]
    tail = tuple(B.shape[1:])
    a = A.reshape(k, k, -1).permute(2, 0, 1)  # (t, k, k)
    bb = B.reshape(k, -1).T  # (t, k)
    zero_col = torch.all(bb == 0, dim=1)  # (t,)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    a_safe = torch.where(zero_col[:, None, None], eye, a)
    sol = torch.linalg.solve_triangular(a_safe, bb.to(A.dtype)[:, :, None], upper=not lower)
    sol = torch.where(zero_col[:, None], 0, sol[:, :, 0])
    return sol.T.reshape((k,) + tail)
