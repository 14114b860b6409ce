"""Captured CUDA graphs with conditional steps: the device side of the
``while_loop`` driver's graph route (:mod:`krylov_tpu_torch._driver`).

:func:`capture` records ``body(guard)`` into a ``torch.cuda.CUDAGraph``.
Inside the body, ``guard(flag, expect, fn)`` captures ``fn()`` into a
conditional IF node whose work runs, at each replay, only when the 0-d
device bool ``flag`` equals ``expect`` at that point of the replay
(``csrc/graph.cu``): the device reads the flag, the host never does.
``guard.loop(counter, limit, fn)`` captures ``fn(counter)`` into a WHILE
node that runs it, and adds one to the 0-d int64 device ``counter``, while
``counter < limit``.  Conditional nodes nest.  ``guard.sibling(pred,
fn)`` captures ``fn()`` in an IF node on ``pred`` that does not nest in
the IF node it is called from: that node's body ends there, the sibling
(on ``pred`` and that node's own flag) follows it in the enclosing graph,
and a second IF node on the first one's flag takes the rest of its body
(a periodic replacement inside a guarded step: on several NCCL ranks its
collectives, captured inside the step's IF body after the step's own,
crashed every rank).  :data:`PLAIN` is the
plain version (:func:`host_guard`, :func:`host_loop`): it reads each flag
on the host and runs ``fn`` or not, so the same body runs step by step on
any device.  :data:`ONCE` runs each body once and reads nothing.  Each
guard keeps this thread's nesting path (:func:`nesting`: ``("if",
"while")`` inside a WHILE body inside an IF body); :func:`launch_nesting`
notes it at each counted launch.

A body is captured on a stream of its own per nesting depth, fixed per
device, and allocates from the device's kept pool (:func:`_bodies_pool`;
:func:`release_pools` gives it back).  :func:`host_reads` notes, on the
calling thread only, the operations that a graph could not replay (a read
of a device value on the host, a copy from the host).

The kernel wrappers and the mesh's collectives count their launches
through :func:`count`.  While
:func:`recording` is on, a launch is not counted but appended to the
recording's list: a captured launch has not run.  The driver credits each
captured step's list once per step that a replay ran.
"""

import contextlib
import ctypes
import functools
import gc
import threading
import time
import types

import torch
from torch.utils import _pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# streams: 0 the capture's own, 1 + d the bodies at nesting depth d
_STREAMS = {}
# the bodies' pool of each device, and whether a live graph holds it
_POOLS = {}
_POOLS_HELD = set()
_POOLS_LOCK = threading.Lock()
# the last capture's instantiation, host seconds
LAST = {"instantiate_s": 0.0}
# .launches: this thread's list while recording; .dry; .path: the
# conditional bodies this thread's work is in; .nesting: launch_nesting's list
_RECORD = threading.local()


def count(table, key):
    """One launch of kernel ``key`` into the wrapper's counter ``table``,
    or, while this thread records a captured step, into that record."""
    noted = getattr(_RECORD, "nesting", None)
    if noted is not None:
        noted.append((table, key, nesting()))
    launches = getattr(_RECORD, "launches", None)
    if launches is None:
        table[key] += 1
    else:
        launches.append((table, key))


def nesting():
    """The conditional bodies this thread's work is captured (or, on the
    plain guards, run) in, outermost first: ``"if"`` or ``"while"`` each."""
    return tuple(getattr(_RECORD, "path", ()))


@contextlib.contextmanager
def _nested(kind):
    path = _RECORD.__dict__.setdefault("path", [])
    path.append(kind)
    try:
        yield
    finally:
        path.pop()


@contextlib.contextmanager
def _unnested():
    """Within: this thread's work is one conditional level up (a sibling)."""
    path = _RECORD.__dict__.setdefault("path", [])
    kind = path.pop()
    try:
        yield
    finally:
        path.append(kind)


def _splits():
    """Whether a sibling called now splits the body it is called from: a
    body of one IF node at the top level."""
    return nesting() == ("if",)


@contextlib.contextmanager
def launch_nesting():
    """Within: each launch this thread counts (:func:`count`) is noted in
    the list yielded as ``(table, key, nesting())``, counted as ever."""
    prev = getattr(_RECORD, "nesting", None)
    _RECORD.nesting = noted = []
    try:
        yield noted
    finally:
        _RECORD.nesting = prev


@contextlib.contextmanager
def recording():
    """Within: this thread's launches go to the list yielded, not to the
    wrappers' counters."""
    prev = getattr(_RECORD, "launches", None)
    _RECORD.launches = launches = []
    try:
        yield launches
    finally:
        _RECORD.launches = prev


@contextlib.contextmanager
def dry():
    """Within: this thread's collectives (:mod:`.parallel.mesh`) launch
    nothing and give tensors of their results' shapes whose values are
    unset: a screen of a step, whose results are dropped, meets no other
    rank."""
    prev = getattr(_RECORD, "dry", False)
    _RECORD.dry = True
    try:
        yield
    finally:
        _RECORD.dry = prev


def is_dry():
    return getattr(_RECORD, "dry", False)


def credit(launches, times):
    """Add ``times`` runs of a recorded step's ``launches`` to the
    counters."""
    for table, key in launches:
        table[key] += times


@functools.cache
def _lib():
    from . import _build

    lib = _build.load()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("krylov_graph_if_begin", [vp, vp, i32, vp]),
        ("krylov_graph_if_end", [vp]),
        ("krylov_graph_while_begin", [vp, vp, vp, vp, ctypes.POINTER(ctypes.c_ulonglong)]),
        ("krylov_graph_while_end", [vp, vp, vp, ctypes.c_ulonglong]),
        ("krylov_graph_runtime_version", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i32
    lib.krylov_error_string.argtypes = [i32]
    lib.krylov_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, what):
    if err:
        lib = _lib()
        raise RuntimeError(
            f"{what}: CUDA error {err}: {lib.krylov_error_string(err).decode()} "
            f"(CUDA runtime {lib.krylov_graph_runtime_version()}; conditional "
            "nodes need 12.4 or later)")


def _stream(index, depth):
    key = (index, depth)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=index)
    return _STREAMS[key]


def _index(device):
    return torch.cuda.current_device() if device.index is None else device.index


def host_guard(flag, expect, fn):
    """The plain guard: ``fn()`` when ``flag`` reads ``expect`` on the
    host, else None."""
    if bool(flag) != expect:
        return None
    with _nested("if"):
        return fn()


def host_loop(counter, limit, fn):
    """The plain loop: ``fn(counter)`` and ``counter += 1`` while
    ``counter < limit``, each test read on the host."""
    with _nested("while"):
        while bool(counter < limit):
            fn(counter)
            counter.add_(1)


def host_sibling(pred, fn):
    """The plain sibling: ``fn()`` when ``pred`` reads true on the host, a
    level up where a captured sibling would be."""
    with _unnested() if _splits() else contextlib.nullcontext():
        host_guard(pred, True, fn)


class _Plain:
    """The plain guards: an IF node's and a WHILE node's flags read on the
    host."""

    __call__ = staticmethod(host_guard)
    loop = staticmethod(host_loop)
    sibling = staticmethod(host_sibling)


PLAIN = _Plain()


class _Once:
    """Guards that run each IF and WHILE body once and read no flag: a
    step's device form run as a capture records it."""

    @staticmethod
    def __call__(flag, expect, fn):
        return fn()

    @staticmethod
    def loop(counter, limit, fn):
        fn(counter)

    @staticmethod
    def sibling(pred, fn):
        fn()


ONCE = _Once()


def _scalar(t, dtype, what):
    if t.dtype != dtype or t.numel() != 1:
        raise TypeError(f"{what} is a one-element {dtype} tensor")


class _Guards:
    def __init__(self, index):
        self.index = index
        self.depth = 0
        self.frames = []  # the open IF nodes: (flag, expect, parent stream)

    def _body(self, fn, args, end, what, kind):
        """``fn(*args)`` captured on the body stream of this depth; ``end``
        ends that capture."""
        self.depth += 1
        try:
            with torch.cuda.stream(_stream(self.index, self.depth)), _nested(kind):
                out = fn(*args)
        except BaseException:
            end()
            raise
        finally:
            self.depth -= 1
        _check(end(), f"the end of {what}")
        return out

    def _if_begin(self, parent, flag, expect, body):
        _check(_lib().krylov_graph_if_begin(parent.cuda_stream, flag.data_ptr(),
                                            int(not expect), body.cuda_stream), "an IF node")

    def __call__(self, flag, expect, fn):
        _scalar(flag, torch.bool, "a guard's flag")
        parent = torch.cuda.current_stream(self.index)
        body = _stream(self.index, 1 + self.depth)
        self._if_begin(parent, flag, expect, body)
        self.frames.append((flag, expect, parent))
        try:
            return self._body(fn, (), lambda: _lib().krylov_graph_if_end(body.cuda_stream),
                              "an IF node", "if")
        finally:
            self.frames.pop()

    def sibling(self, pred, fn):
        """``fn()`` in an IF node on ``pred``; called in the body of one IF
        node at the top level, the node beside it (see the module
        docstring), else nested where it is called."""
        _scalar(pred, torch.bool, "a guard's flag")
        if not _splits():
            return self(pred, True, fn)
        flag, expect, parent = self.frames[-1]
        body = torch.cuda.current_stream(self.index)
        _check(_lib().krylov_graph_if_end(body.cuda_stream), "the end of an IF node")
        self.depth -= 1
        try:
            with torch.cuda.stream(parent), _unnested():
                # the enclosing node ran (its flag as it expects) and pred holds
                go = pred & (flag if expect else ~flag)
                self(go, True, fn)
        finally:
            self.depth += 1
            # the rest of the enclosing node's body, on its flag again
            self._if_begin(parent, flag, expect, body)

    def loop(self, counter, limit, fn):
        _scalar(counter, torch.int64, "a loop's counter")
        _scalar(limit, torch.int64, "a loop's limit")
        lib = _lib()
        parent = torch.cuda.current_stream(self.index)
        body = _stream(self.index, 1 + self.depth)
        handle = ctypes.c_ulonglong(0)
        _check(lib.krylov_graph_while_begin(parent.cuda_stream, counter.data_ptr(),
                                            limit.data_ptr(), body.cuda_stream,
                                            ctypes.byref(handle)), "a WHILE node")
        self._body(fn, (counter,), lambda: lib.krylov_graph_while_end(
            body.cuda_stream, counter.data_ptr(), limit.data_ptr(), handle.value),
            "a WHILE node", "while")


# operations that read a device value on the host (a scalar, or a size
# that depends on the values)
_HOST_READ_OPS = frozenset((
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select", "aten::_unique2",
    "aten::unique_consecutive", "aten::unique_dim", "aten::repeat_interleave",
    "aten::_linalg_check_errors"))
# the functions that make a tensor from host data, which reach the device
# as a copy that no dispatched operation shows
_FROM_HOST = (torch.tensor, torch.as_tensor, torch.asarray)


class _Screen(TorchDispatchMode):
    """A dispatch mode of the graph route's screen.  ``TorchDispatchMode``
    wraps a subclass's ``__torch_dispatch__`` in ``torch._disable_dynamo``
    unless the class says otherwise, and that wrapper's first call imports
    ``torch._dynamo`` (with sympy, some 800 modules and seconds of a
    process's first graph-route solve).  A screen compiles nothing."""

    @classmethod
    def _should_skip_dynamo(cls):
        return False


class _HostReads(_Screen):
    """Notes each operation of this thread that a CUDA graph could not
    replay: a read of a value of a tensor on ``device_type`` on the host, a
    boolean-mask index of such a tensor, or an operation that mixes host
    tensors with such tensors (a copy from the host)."""

    def __init__(self, device_type, seen):
        super().__init__()
        self.device_type, self.seen = device_type, seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        tensors = [t for t in _pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        kinds = {t.device.type for t in tensors}
        if name == "aten::_to_copy" and "device" in kwargs and kwargs["device"] is not None:
            kinds.add(torch.device(kwargs["device"]).type)
        mask = name.startswith("aten::index") and any(
            t.dtype in (torch.bool, torch.uint8) for t in tensors[1:])
        if self.device_type in kinds and (name in _HOST_READ_OPS or len(kinds) > 1 or mask):
            self.seen.append(f"{name} on {sorted(kinds)}")
        return func(*args, **kwargs)


class _HostData(TorchFunctionMode):
    """Notes each tensor that this thread makes on a ``device_type`` that
    is not the host's from host data (``torch.tensor(3.0, device=...)``)."""

    def __init__(self, device_type, seen):
        super().__init__()
        self.device_type, self.seen = device_type, seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in _FROM_HOST and self.device_type != "cpu" and isinstance(out, torch.Tensor)
                and out.device.type == self.device_type
                and not (args and isinstance(args[0], torch.Tensor)
                         and args[0].device.type == self.device_type)):
            self.seen.append(f"torch.{func.__name__} of host data")
        return out


@contextlib.contextmanager
def host_reads(device_type):
    """Within: this thread's operations that read a value of a tensor on
    ``device_type`` on the host, or copy one from the host, are noted in
    the list yielded (by name), and run as ever.  Other threads are not
    watched."""
    seen = []
    with _HostData(device_type, seen), _HostReads(device_type, seen):
        yield seen


class _StoragesRead(_Screen):
    """Adds ``(storage, dtype, shape)`` of each strided tensor an
    operation of this thread reads to ``reads``, but for tensors that an
    earlier operation within made."""

    def __init__(self, reads):
        super().__init__()
        self.reads, self.made = reads, set()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                ptr = t.untyped_storage().data_ptr()
                if ptr not in self.made:
                    self.reads.add((ptr, t.dtype, tuple(t.shape)))
        out = func(*args, **kwargs)
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                self.made.add(t.untyped_storage().data_ptr())
        return out


def storages_read(reads):
    """Within: the storages this thread's operations read, but those made
    within, are added to the set ``reads`` as ``(storage pointer, dtype,
    shape)``: what a captured step would read at a fixed address."""
    return _StoragesRead(reads)


_LEAVES = (str, bytes, int, float, complex, bool, type(None), type, types.ModuleType,
           torch.dtype, torch.device, threading.Thread)


def reachable_storages(roots, limit=200_000):
    """The storage pointers of the strided tensors reached from ``roots``
    through containers, attributes, bound methods, partials and closures
    (a built solver's operator, preconditioner and reductions), at most
    ``limit`` objects walked."""
    out, seen, todo = set(), set(), list(roots)
    while todo and len(seen) < limit:
        o = todo.pop()
        if id(o) in seen or isinstance(o, _LEAVES):
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            if o.layout == torch.strided:
                out.add(o.untyped_storage().data_ptr())
            continue
        if isinstance(o, dict):
            todo.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            todo.extend(o)
        elif isinstance(o, functools.partial):
            todo.extend((o.func, o.args, o.keywords))
        elif isinstance(o, types.MethodType):
            todo.extend((o.__self__, o.__func__))
        elif isinstance(o, types.FunctionType):
            for cell in o.__closure__ or ():
                try:
                    todo.append(cell.cell_contents)
                except ValueError:  # a cell not yet filled
                    pass
            todo.extend(o.__defaults__ or ())
            todo.extend((o.__kwdefaults__ or {}).values())
        else:
            todo.extend(getattr(o, "__dict__", {}).values())
            for name in getattr(type(o), "__slots__", ()):
                todo.append(getattr(o, name, None))
    return out


def on_body_stream(fn, device):
    """``fn()`` run now on the stream the outermost bodies are captured on,
    ordered after the current stream's work and before its later work: the
    step before a capture makes that stream's own state (a cuBLAS
    workspace) there, outside any capture."""
    index = _index(device)
    cur = torch.cuda.current_stream(index)
    body = _stream(index, 1)
    body.wait_stream(cur)
    with torch.cuda.stream(body):
        out = fn()
    cur.wait_stream(body)
    return out


def _bodies_pool(index):
    """``(pool, give_back)``: the memory pool a capture allocates from, and
    what :meth:`Captured.release` calls once the graph is gone.

    The device keeps one pool for the next capture: a solve's steps
    allocate the same sizes again, and a pool made anew for each solve
    paid ``cudaMalloc`` during the capture and a synchronizing ``cudaFree``
    at its release.  Its free blocks serve any allocation that would
    otherwise run out of memory (``use_on_oom``).  While a live graph holds
    it, another capture (a solve on another thread) gets a pool of its own,
    freed with its graph."""
    with _POOLS_LOCK:
        if index in _POOLS_HELD:
            return torch.cuda.MemPool(use_on_oom=True), None
        if index not in _POOLS:
            _POOLS[index] = torch.cuda.MemPool(use_on_oom=True)
        _POOLS_HELD.add(index)
    return _POOLS[index], lambda: _POOLS_HELD.discard(index)


def release_pools():
    """Drop each device's kept pool that no live graph holds: its memory
    goes back to the device at the next ``torch.cuda.empty_cache()``, and
    the next capture makes a new one.  Returns the devices whose pools
    were dropped."""
    with _POOLS_LOCK:
        dropped = [i for i in _POOLS if i not in _POOLS_HELD]
        for i in dropped:
            del _POOLS[i]
    return dropped


class Captured:
    """A captured graph: :meth:`replay` launches it on the current stream,
    :meth:`release` drops it and gives back its memory pool."""

    def __init__(self, graph, pool, give_back):
        self._graph, self._pool, self._give_back = graph, pool, give_back

    def replay(self):
        self._graph.replay()

    def release(self):
        # the graph first: its executable reads the pool's blocks
        self._graph = self._pool = None
        if self._give_back is not None:
            with _POOLS_LOCK:
                self._give_back()
            self._give_back = None


def capture(body, device, mode="global", own_pool=False):
    """``body(guard)`` captured on ``device``; returns a :class:`Captured`.
    ``own_pool``: allocate from a pool of the graph's own, freed with it
    (a graph kept across solves), not the device's kept one.

    Any exception raised inside ``body`` (an operation the capture refuses,
    such as a read of a device value on the host) ends the capture and is
    raised again; the graph is then never instantiated.  ``mode`` is the
    capture's error mode (``torch.cuda.CUDAGraph.capture_begin``):
    ``"thread_local"`` lets other threads call what a capture forbids, as
    a process group's watchdog queries the events of its collectives."""
    index = _index(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # the graph's own pool takes its capture stream's allocations; the
    # bodies' streams capture into IF nodes under capture sequences of
    # their own, so every allocation of the capture goes to the kept pool
    bodies, give_back = ((torch.cuda.MemPool(use_on_oom=True), None) if own_pool
                         else _bodies_pool(index))
    cur = torch.cuda.current_stream(index)
    side = _stream(index, 0)
    side.wait_stream(cur)
    failure = None
    # a capture makes many short-lived objects and no garbage cycles: a
    # collection of a large process's heap in the middle would only stall it
    collecting = gc.isenabled()
    gc.disable()
    with torch.cuda.device(index), torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode=mode)
        try:
            with torch.cuda.use_mem_pool(bodies, index):
                body(_Guards(index))
        except Exception as exc:  # noqa: BLE001 - raised below, after the capture ends
            failure = exc
        finally:
            if collecting:
                gc.enable()
        try:
            graph.capture_end()
        except Exception as exc:  # noqa: BLE001 - raised below
            failure = failure or exc
    cur.wait_stream(side)
    captured = Captured(graph, bodies, give_back)
    if failure is not None:
        graph.reset()
        captured.release()
        raise failure
    t0 = time.perf_counter()
    graph.instantiate()
    LAST["instantiate_s"] = time.perf_counter() - t0
    return captured
