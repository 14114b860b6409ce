"""Generic iteration drivers (shared by all solvers).

Counterpart of ``krylov_tpu._driver``: the solve loop exists once, with the
same control-flow contract in both backends:

* convergence criterion ``max(tol * resnorms[0], atol)`` fixed up-front,
* an **explicit-residual double check**: when the recurrence residual norm
  dips below the criterion, the true residual is recomputed and
  *overwrites* the last history entry; success is declared only if the
  explicit value also passes (the overwrite persists even if it does not),
* ``maxiter`` bail-out, ``callback(x, r)`` fired ``numsteps + 1`` times
  (once by the solver before the loop, once per step here), absolute
  resnorm history of shape ``(numsteps + 1, *rhs)``.

Backends:

* ``eager`` — host loop keeping the history as a list of per-step values;
  supports ``on_step`` bookkeeping and is the float64 parity mode on CPU,
* ``while_loop`` — device-resident loop: the state and a preallocated
  ``(maxiter + 1, *rhs)`` history tensor stay on the solve's device, and the
  only host read per step is one stop flag.  It keeps the nested structure
  of the reference's compiled driver: the inner loop only steps, the outer
  loop runs once per convergence event and performs the explicit recheck.

Solver-specific state is any object carrying at least ``resnorm``.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

EAGER = "eager"
WHILE_LOOP = "while_loop"


class Method(NamedTuple):
    """Hooks describing one Krylov method to the generic drivers."""

    step: Callable[[Any, Any], Any]  # (state, criterion) -> state
    xk: Callable[[Any], Any]  # state -> current solution iterate
    # recompute the true residual norm of an iterate; None disables the
    # double-check
    explicit_resnorm: Optional[Callable[[Any], Any]] = None
    # state -> args tuple for the user callback
    callback_args: Optional[Callable[[Any], tuple]] = None
    # eager-only bookkeeping hook, e.g. cg's return_arnoldi basis collection
    on_step: Optional[Callable[[Any, Any], None]] = None


def run(
    state0,
    method: Method,
    *,
    tol: float,
    atol: float,
    maxiter: int,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Drive ``method`` to convergence.

    Returns ``(state, success, numsteps, resnorms)`` where ``resnorms`` is a
    host ndarray of shape ``(numsteps + 1, *rhs)``.
    """
    if backend == EAGER:
        return _run_eager(
            state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback
        )
    if backend == WHILE_LOOP:
        if method.on_step is not None:
            raise ValueError("on_step bookkeeping requires backend='eager'")
        return _run_while(
            state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback
        )
    raise ValueError(f"unknown backend {backend!r}")


def _criterion(resnorm0, tol, atol):
    return torch.clamp(tol * resnorm0, min=atol)


def _fire(method, callback, state):
    if callback is not None and method.callback_args is not None:
        callback(*method.callback_args(state))


def _run_eager(state, method: Method, *, tol, atol, maxiter, callback):
    resnorms = [state.resnorm]
    criterion = _criterion(resnorms[0], tol, atol)
    success = False
    k = 0
    while True:
        if bool(torch.all(resnorms[-1] <= criterion)):
            if method.explicit_resnorm is None:
                success = True
                break
            rn = method.explicit_resnorm(method.xk(state))
            resnorms[-1] = rn  # overwrite persists even if the check fails
            if bool(torch.all(rn <= criterion)):
                success = True
                break
        if k == maxiter:
            break

        new_state = method.step(state, criterion)
        if method.on_step is not None:
            method.on_step(state, new_state)
        state = new_state
        _fire(method, callback, state)
        resnorms.append(state.resnorm)
        k += 1

    return state, success, k, torch.stack(resnorms).cpu().numpy()


def _run_while(state, method: Method, *, tol, atol, maxiter, callback):
    resnorm0 = state.resnorm
    buf = resnorm0.new_zeros((maxiter + 1,) + tuple(resnorm0.shape))
    buf[0] = resnorm0
    criterion = _criterion(resnorm0, tol, atol)
    k = 0
    while True:
        # outer loop: once per convergence event (start, dip below the
        # criterion, maxiter)
        ok = bool(torch.all(buf[k] <= criterion))
        if ok and method.explicit_resnorm is not None:
            rn = method.explicit_resnorm(method.xk(state)).to(buf.dtype)
            buf[k] = rn  # overwrite persists even if the check fails
            ok = bool(torch.all(rn <= criterion))
        if ok or k >= maxiter:
            break
        # inner loop: steps only, one stop-flag read per step
        while True:
            state = method.step(state, criterion)
            _fire(method, callback, state)
            k += 1
            buf[k] = state.resnorm
            if k >= maxiter or bool(torch.all(state.resnorm <= criterion)):
                break
    return state, ok, k, buf[: k + 1].cpu().numpy()
