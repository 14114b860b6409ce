"""The step number of a counted step, and the control flow that depends
on it (:class:`krylov_tpu_torch._driver.Method` ``counted=True``).

Counterpart of the three device-side constructs of the reference's compiled
``while_loop``: ``jnp.where`` on a step counter carried in the state,
``lax.cond`` for a dear branch and ``lax.fori_loop(0, k + 1)`` for a sweep
whose length grows with the step.  A counted step takes a third argument,
its control, in one of two forms:

* :class:`HostStep` (the eager driver, the host-stepped loop, a rehearsal
  step): ``k`` is the host's count.  ``pick`` evaluates the branch its
  predicate names, ``cond`` runs its function or not, ``loop`` is a Python
  ``for``; nothing is read back from the device;
* :class:`DeviceStep` (a step of the graph route): ``k`` is the driver's
  0-d int64 device counter.  ``pick`` evaluates both branches and selects
  with ``torch.where``, ``cond`` is an IF node beside the step's guard and
  ``loop`` a WHILE node (:mod:`._graphs`; the CPU twin reads their flags
  on the host).

:func:`at`, :func:`put` and :func:`add_at` index with a host int (a view, an
assignment) or a 0-d tensor (``index_select``, ``index_copy_``,
``index_add_``).  The value a step keeps is computed by the same operations
in both forms, so the routes agree bit for bit.
"""

import torch

# the counted sites (a cond's or a loop's body that launches a counted
# kernel) a captured graph may hold
MAX_SITES = 256


def _index(j, n=1):
    """The 1-D index tensor of rows ``j .. j + n - 1`` (``j`` a 0-d tensor)."""
    j = j.reshape(1)
    return j if n == 1 else j + torch.arange(n, device=j.device)


def owned(t, *others):
    """``t``, or a clone of it where it shares memory with one of
    ``others``: a buffer that a loop's body may write in place."""
    ptr = t.untyped_storage().data_ptr()
    if any(o.untyped_storage().data_ptr() == ptr for o in others):
        return t.clone()
    return t


def at(T, j):
    """Row ``j`` of ``T``: a view for a host int, a copy for a 0-d tensor."""
    if isinstance(j, int):
        return T[j]
    return T.index_select(0, _index(j)).squeeze(0)


def rows(T, j, n):
    """Rows ``j .. j + n - 1`` of ``T``."""
    if isinstance(j, int):
        return T[j: j + n]
    return T.index_select(0, _index(j, n))


def put(T, j, v, n=None):
    """``T[j] = v`` (``T[j: j + n] = v`` with ``n``), in place."""
    if isinstance(j, int):
        dst = T[j] if n is None else T[j: j + n]
        if isinstance(v, torch.Tensor):
            dst.copy_(v)
        else:  # a fill: an assigned Python number is copied from the host
            dst.fill_(v)
        return
    v = (v.to(T.dtype) if isinstance(v, torch.Tensor)
         else torch.full((), v, dtype=T.dtype, device=T.device))
    if n is None:
        T.index_copy_(0, _index(j), v.expand(T.shape[1:]).unsqueeze(0))
    else:
        T.index_copy_(0, _index(j, n), v.expand((n,) + T.shape[1:]))


def put_head(T, n, v):
    """``T[:n] = v[:n]``, in place: on the device a select against the row
    index, over the rows both have."""
    if isinstance(n, int):
        T[:n] = v[:n]
        return
    m = min(T.shape[0], v.shape[0])
    idx = torch.arange(m, device=T.device).reshape((m,) + (1,) * (T.ndim - 1))
    T[:m] = torch.where(idx < n, v[:m].to(T.dtype), T[:m])


def put2(T, i, j, v):
    """``T[i, j] = v``, in place (``T`` contiguous)."""
    if isinstance(i, int):
        T[i, j] = v
        return
    flat = T.view((-1,) + T.shape[2:])
    flat.index_copy_(0, (i * T.shape[1] + j).reshape(1), v.to(T.dtype).unsqueeze(0))


def put_col(T, j, v):
    """``T[:, j] = v``, in place."""
    if isinstance(j, int):
        T[:, j] = v
        return
    T.index_copy_(1, _index(j), v.to(T.dtype).unsqueeze(1))


def add_at(T, j, v, n=None):
    """``T[j] += v`` (``T[j: j + n] += v`` with ``n``), in place."""
    if isinstance(j, int):
        if n is None:
            T[j] += v
        else:
            T[j: j + n] += v
        return
    if n is None:
        T.index_add_(0, _index(j), v.to(T.dtype).unsqueeze(0))
    else:
        T.index_add_(0, _index(j, n), v.to(T.dtype))


class HostStep:
    """A step's control on the host: ``k`` is an int."""

    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    @staticmethod
    def pick(pred, a, b):
        """``a()`` where the host bool ``pred`` holds, else ``b()``."""
        return a() if pred else b()

    @staticmethod
    def cond(pred, fn):
        """``fn()`` where ``pred`` holds."""
        if pred:
            fn()

    @staticmethod
    def loop(n, fn):
        """``fn(j)`` for ``j`` in ``range(n)``."""
        for j in range(n):
            fn(j)


def _where(pred, a, b):
    if isinstance(a, tuple):
        return tuple(_where(pred, x, y) for x, y in zip(a, b, strict=True))
    if a.dtype != b.dtype or a.shape != b.shape:
        raise TypeError(f"pick's branches differ: {a.dtype}{tuple(a.shape)} against "
                        f"{b.dtype}{tuple(b.shape)}")
    return torch.where(pred, a, b)


class DeviceStep:
    """A step's control on the graph route: ``k`` is the driver's 0-d int64
    device counter, ``guard`` the capture's guards (IF nodes, and WHILE
    nodes through ``guard.loop``) or their plain twin.  ``sites``: in a
    capture, the list the counted kernel launches of each cond's or loop's
    body go to, and ``tallies`` the device counts of the runs of each (the
    driver credits ``tallies[i]`` runs of ``sites[i]``); None in the twin,
    whose launches run where they are counted."""

    def __init__(self, k, guard, sites=None, tallies=None):
        self.k, self.guard, self.sites, self.tallies = k, guard, sites, tallies

    @staticmethod
    def pick(pred, a, b):
        """Both branches, selected by the device bool ``pred``
        (``torch.where``); a branch may return a tuple of tensors, of the
        same dtypes and shapes as the other's."""
        return _where(pred, a(), b())

    def cond(self, pred, fn):
        """``fn()`` in an IF node on the device bool ``pred``; ``fn``
        writes its results in place (its tensors are unset where the node
        did not run).  Called in a guarded step's body, the node is the
        guard's sibling, not nested in it (``guard.sibling``): a body that
        runs collectives sits one conditional level deep, as the step's
        own do."""
        self.guard.sibling(pred, self._counted(fn))

    def loop(self, n, fn):
        """``fn(j)`` for ``j`` from 0 while ``j < n`` (a 0-d int64 device
        tensor), in a WHILE node: ``j`` is a 0-d device tensor, and ``fn``
        writes its results in place."""
        j = torch.zeros((), dtype=torch.int64, device=n.device)
        self.guard.loop(j, n, self._counted(fn))

    def _counted(self, fn):
        """``fn`` with the counted launches of its body kept as a site of
        their own, credited by a device tally of its runs."""
        if self.sites is None:
            return fn
        from . import _graphs

        def body(*args):
            with _graphs.recording() as launches:
                fn(*args)
            if launches:
                i = len(self.sites)
                if i >= MAX_SITES:
                    raise RuntimeError(f"a graph holds at most {MAX_SITES} counted sites")
                self.sites.append(launches)
                self.tallies[i].add_(1)

        return body
