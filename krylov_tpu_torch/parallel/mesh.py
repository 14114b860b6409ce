"""The ``(rows, rhs)`` process mesh, its transport and mesh-aware reductions.

Counterpart of ``krylov_tpu.parallel.mesh``.  The reference is one program
over a JAX device mesh (``shard_map``); here every rank is a process of a
``torch.distributed`` world, each with its own device, and every rank runs
the same solve on its own slab:

* the ``rows`` axis partitions the operator's rows and every iterate
  vector; the ``rhs`` axis partitions right-hand-side columns (pure data
  parallelism: no communication crosses it);
* inner products become an ``all_reduce`` over ``rows`` (``psum`` in the
  reference), the halo ``ppermute`` a pair of point-to-point transfers
  (:meth:`Mesh.start_exchange`), the tiled ``all_gather`` an
  ``all_gather_into_tensor`` (:meth:`Mesh.all_gather_rows`).

The transport lives here and nowhere else.  It follows the backend of the
world: device tensors travel on NCCL, CPU tensors on gloo.  Gloo with CUDA
tensors (several ranks sharing one card, where NCCL refuses a second rank)
stages every transfer through the host explicitly, in :func:`_staged`,
counted in :data:`STAGED`; nothing else chooses the host.  Every group is
created with a timeout, so a rank that diverges from the others raises in
its next collective instead of hanging.

A rank alone on an axis launches nothing along it: a sum over one rank is
its operand, a gather of one slab is that slab, and the halo exchange has
no neighbour to meet (the reference's ``psum`` over an axis of size 1
compiles to nothing).  :meth:`Mesh.alone` is the one place that decides.
Within :func:`krylov_tpu_torch._graphs.dry` (the graph route's screen of
a step) no rank launches any: the results have their shapes, not values.
:data:`COUNTS` counts the collectives launched, through
:func:`krylov_tpu_torch._graphs.count`: a collective captured into a CUDA
graph is credited once for each replayed step that ran it, as a kernel
launch is.

A built solver's kept graph (:class:`krylov_tpu_torch._driver.Kept`) may
hold captured collectives of its rows group (several NCCL ranks on the
graph route), and NCCL's teardown of a communicator waits until every
graph that holds its captured work is gone.  Such a slot is held here
(:func:`hold`) and released by :func:`release_kept`: this module's
``torch.distributed.destroy_process_group`` (installed in its place at
import) calls it before a group, or every group before the world, is torn
down, and so does the interpreter's exit.  A script that bound
``destroy_process_group`` before importing this package keeps torch's own
function: it calls :func:`release_kept` (``parallel.release_kept()``)
before it.
"""

import atexit
import datetime
import functools
import os
import tempfile
import weakref

import torch
import torch.distributed as dist

from .. import _device, _graphs

ROWS = "rows"
RHS = "rhs"

DEFAULT_TIMEOUT = 60.0  # seconds a collective waits for the other ranks

# collective launches by kind (none along an axis of one rank); host-staged
# transfers (gloo with CUDA tensors)
COUNTS = {"all_reduce": 0, "exchange": 0, "all_gather": 0, "reduce_scatter": 0}
STAGED = {"all_reduce": 0, "exchange": 0, "all_gather": 0, "reduce_scatter": 0}

# the tiled gather and scatter under their current names (older torch has
# only the ``*_tensor`` ones)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

_GROUPS = {}  # (ranks, timeout) -> group, for the world in _GROUPS_WORLD
_GROUPS_WORLD = [None]


# the kept slots whose graphs hold collectives, each with their group:
# released before the group goes
_HELD = weakref.WeakKeyDictionary()


def reset_counts():
    for counts in (COUNTS, STAGED):
        for k in counts:
            counts[k] = 0


def _timedelta(seconds):
    return datetime.timedelta(seconds=float(seconds))


def _world_of_one(device, timeout):
    """Start a world of one rank through a ``file://`` store in a fresh
    temporary directory: NCCL for a CUDA device, gloo for the CPU."""
    path = os.path.join(tempfile.mkdtemp(prefix="krylov_mesh_"), "store")
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{path}", rank=0, world_size=1,
        timeout=_timedelta(timeout),
    )


def _mesh_device(device):
    if device is not None:
        return torch.device(device)
    if _device._default is not None or not torch.cuda.is_available():
        return _device.default_device()  # raises without CUDA and without a choice
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _group(ranks, timeout):
    """The process group of ``ranks`` (every rank of the world calls this
    in the same order, as ``new_group`` needs), made once per world."""
    world = dist.group.WORLD
    if _GROUPS_WORLD[0] is not world:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = world
    key = (tuple(ranks), float(timeout))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), timeout=_timedelta(timeout))
    return _GROUPS[key]


class Mesh:
    """This rank's view of a ``(rows, rhs)`` mesh of ranks.

    Global rank ``r`` sits at ``(r // n_rhs, r % n_rhs)``, the reference's
    row-major device grid.  ``shape`` maps the axis names to their sizes
    (``mesh.shape[ROWS]``, as a JAX mesh), ``coord`` maps them to this
    rank's coordinates, ``device`` is where its slabs live.
    """

    def __init__(self, n_rows, n_rhs, device, timeout):
        rank = dist.get_rank()
        self.shape = {ROWS: n_rows, RHS: n_rhs}
        self.device = device
        self.timeout = float(timeout)
        self.backend = dist.get_backend()
        if device.type == "cpu" and "gloo" not in self.backend:
            raise ValueError(f"a CPU mesh needs gloo; the world runs {self.backend}")
        # gloo carrying CUDA tensors: every transfer goes through the host
        self.staged = device.type == "cuda" and "nccl" not in self.backend
        groups = {ROWS: {}, RHS: {}}
        for j in range(n_rhs):  # every rank makes every group, in one order
            ranks = [i * n_rhs + j for i in range(n_rows)]
            groups[ROWS][j] = (ranks, _group(ranks, timeout))
        for i in range(n_rows):
            ranks = [i * n_rhs + j for j in range(n_rhs)]
            groups[RHS][i] = (ranks, _group(ranks, timeout))
        if rank >= n_rows * n_rhs:
            raise ValueError(f"rank {rank} lies outside the {n_rows} x {n_rhs} mesh")
        self.coord = {ROWS: rank // n_rhs, RHS: rank % n_rhs}
        self._ranks = {ROWS: groups[ROWS][self.coord[RHS]][0],
                       RHS: groups[RHS][self.coord[ROWS]][0]}
        self._groups = {ROWS: groups[ROWS][self.coord[RHS]][1],
                        RHS: groups[RHS][self.coord[ROWS]][1]}

    @classmethod
    def of_one(cls, device):
        """This process alone on both axes, with no process group: a mesh
        whose every collective gives its operand (a sharded operator's
        single-device twin)."""
        mesh = cls.__new__(cls)
        mesh.shape, mesh.coord = {ROWS: 1, RHS: 1}, {ROWS: 0, RHS: 0}
        mesh.device, mesh.timeout = torch.device(device), DEFAULT_TIMEOUT
        mesh.backend, mesh.staged = None, False
        mesh._ranks, mesh._groups = {ROWS: (0,), RHS: (0,)}, {ROWS: None, RHS: None}
        return mesh

    def group(self, axis=ROWS):
        return self._groups[axis]

    def alone(self, axis=ROWS):
        """Whether this rank is the only one on ``axis``: then nothing is
        launched along it."""
        return self.shape[axis] == 1

    def neighbours(self, axis=ROWS):
        """Whether this rank has a previous and a next rank along ``axis``."""
        i = self.coord[axis]
        return i > 0, i + 1 < self.shape[axis]

    # -- transport ---------------------------------------------------------

    def all_reduce(self, t, axis=ROWS, op=dist.ReduceOp.SUM):
        """The sum (or ``op``) of ``t`` over ``axis``: a new tensor, or
        ``t`` itself on a rank alone on ``axis``."""
        if self.alone(axis) or _graphs.is_dry():
            return t
        _graphs.count(COUNTS, "all_reduce")

        def run(buf):
            dist.all_reduce(_real(buf), op=op, group=self._groups[axis])
            return buf

        return self._transfer("all_reduce", run, t.contiguous().clone())

    def all_gather_rows(self, x, axis=ROWS):
        """The slabs of ``axis`` stacked along axis 0, in mesh order
        (``lax.all_gather(..., tiled=True)``); ``x`` itself on a rank
        alone on ``axis``."""
        if self.alone(axis):
            return x
        n = self.shape[axis]
        if _graphs.is_dry():
            return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _graphs.count(COUNTS, "all_gather")

        def run(buf):
            out = torch.empty((n * buf.shape[0],) + tuple(buf.shape[1:]), dtype=buf.dtype,
                              device=buf.device)
            _all_gather(_real(out), _real(buf), group=self._groups[axis])
            return out

        return self._transfer("all_gather", run, x.contiguous())

    def reduce_scatter_rows(self, t, axis=ROWS):
        """Block ``coord[axis]`` along axis 0 of the sum of ``t`` over
        ``axis`` (``lax.psum_scatter(..., tiled=True)``); ``t`` itself on a
        rank alone on ``axis``."""
        if self.alone(axis):
            return t
        n = self.shape[axis]
        if _graphs.is_dry():
            return t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        _graphs.count(COUNTS, "reduce_scatter")

        def run(buf):
            out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                              device=buf.device)
            _reduce_scatter(_real(out), _real(buf), group=self._groups[axis])
            return out

        return self._transfer("reduce_scatter", run, t.contiguous())

    def start_exchange(self, to_next, to_prev, axis=ROWS):
        """Send ``to_next`` to the next rank of ``axis`` and ``to_prev`` to
        the previous one (either may be None), all transfers in flight at
        once.  ``wait()`` on the result gives ``(from_prev, from_next)``:
        the previous rank's ``to_next`` and the next rank's ``to_prev``,
        zeros at the edges of the mesh (the reference's ``ppermute`` with
        no wrap, which fills the ranks that receive nothing with zeros).
        A rank alone on ``axis`` sends and receives nothing."""
        if not (self.alone(axis) or _graphs.is_dry()):
            _graphs.count(COUNTS, "exchange")
        return _Exchange(self, to_next, to_prev, axis)

    def shift(self, x, direction, axis=ROWS):
        """``x`` moved one rank along ``axis``: from rank i to i + 1 for
        ``direction=+1``, to i - 1 for ``-1``; zeros where nothing
        arrives."""
        if direction == +1:
            return self.start_exchange(x, None, axis).wait()[0]
        if direction == -1:
            return self.start_exchange(None, x, axis).wait()[1]
        raise ValueError(f"direction must be +1 or -1, not {direction!r}")

    def _transfer(self, kind, run, t):
        if self.staged:
            return _staged(kind, run, t)
        return run(t)


def _real(t):
    """Complex tensors travel as their real view (sums stay exact)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _staged(kind, run, t):
    """The one place a transfer leaves the card for the host: gloo with
    CUDA tensors.  Copies ``t`` to the host, runs the collective there and
    copies the result back, counted in :data:`STAGED`."""
    STAGED[kind] += 1
    return run(t.cpu()).to(t.device)


class _Exchange:
    """Halo transfers in flight; see :meth:`Mesh.start_exchange`."""

    def __init__(self, mesh, to_next, to_prev, axis):
        self._mesh = mesh
        ranks = mesh._ranks[axis]
        i = mesh.coord[axis]
        prev_rank = ranks[i - 1] if i > 0 else None
        next_rank = ranks[i + 1] if i + 1 < len(ranks) else None
        group = mesh._groups[axis]
        self._like = (to_next, to_prev)
        self._recv = [None, None]  # from_prev, from_next
        ops = []
        if mesh.alone(axis) or _graphs.is_dry():
            to_next = to_prev = None  # nothing sent, zeros received
        elif mesh.staged:
            STAGED["exchange"] += 1
        for slot, (src, peer_out, peer_in) in enumerate(
            ((to_next, next_rank, prev_rank), (to_prev, prev_rank, next_rank))
        ):
            if src is None:
                continue
            # the transfer whose data moves towards +1 (slot 0) or -1 (slot 1)
            buf = src.contiguous()
            if mesh.staged:
                buf = buf.cpu()
            if peer_out is not None:
                ops.append(dist.P2POp(dist.isend, _real(buf), peer_out, group))
            if peer_in is not None:
                got = torch.empty_like(buf)
                ops.append(dist.P2POp(dist.irecv, _real(got), peer_in, group))
                self._recv[slot] = got
        self._works = dist.batch_isend_irecv(ops) if ops else []
        self._ops = ops  # the send buffers live until the transfers end

    def wait(self):
        for w in self._works:
            w.wait()
        self._ops = None
        out = []
        for slot, like in enumerate(self._like):
            got = self._recv[slot]
            if like is None:
                out.append(None)
            elif got is None:
                out.append(torch.zeros_like(like))  # the edge of the mesh
            else:
                out.append(got.to(self._mesh.device) if self._mesh.staged else got)
        return tuple(out)


def hold(slot, mesh):
    """Release :class:`~krylov_tpu_torch._driver.Kept` ``slot`` (a built
    solver's kept graph, whose steps launch collectives along the rows
    axis) before the rows group of ``mesh`` is torn down."""
    _HELD[slot] = mesh.group(ROWS)


def release_kept(group=None):
    """Release what this module keeps of ``group``, or of every group,
    before its teardown: the held kept graphs (the next run of their
    solvers captures anew; NCCL's destruction of a communicator waits for
    every graph holding its captured collectives, and a live one hangs
    it), and the group in the cache of groups (a later mesh makes its
    own)."""
    world = group is None or group is dist.group.WORLD
    for slot, of in list(_HELD.items()):
        if world or of is group:
            del _HELD[slot]
            slot.release()
    for key, of in list(_GROUPS.items()):
        if world or of is group:
            del _GROUPS[key]


atexit.register(release_kept)
_destroy = dist.destroy_process_group


@functools.wraps(_destroy)
def destroy_process_group(group=None):
    release_kept(group)
    return _destroy(group)


destroy_process_group.releases_kept_graphs = True
if not getattr(dist.destroy_process_group, "releases_kept_graphs", False):
    dist.destroy_process_group = destroy_process_group
    dist.distributed_c10d.destroy_process_group = destroy_process_group


def make_mesh(n_rows=None, n_rhs=1, device=None, timeout=DEFAULT_TIMEOUT):
    """This rank's ``(rows, rhs)`` mesh.

    ``n_rows=None`` puts every rank of the world on the rows axis.  Every
    rank of the world calls this with the same arguments (it creates the
    process groups).  ``device`` is where this rank's slabs live: by
    default ``cuda:LOCAL_RANK % device_count()``, or the device named with
    :func:`krylov_tpu_torch.set_default_device`.  With no process group
    initialized, a world of one rank starts here (NCCL on a CUDA device,
    gloo on the CPU), so a sharded solve needs no set-up on one device, as
    the reference's on one device.  ``timeout`` (seconds) bounds every
    collective of the mesh.
    """
    dev = _mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's point-to-point transfers need it
    if not dist.is_initialized():
        _world_of_one(dev, timeout)
    world = dist.get_world_size()
    if n_rows is None:
        n_rows = world // n_rhs
    if n_rows * n_rhs > world:
        raise ValueError(
            f"mesh ({n_rows} x {n_rhs}) needs {n_rows * n_rhs} ranks, have {world}"
        )
    return Mesh(int(n_rows), int(n_rhs), dev, timeout)


def psum_inner(b_shape, mesh, axis=ROWS):
    """Mesh-aware default inner product: the port's default contraction
    (conjugated, over the leading axis; per column for a multi-RHS block)
    followed by an ``all_reduce`` over ``axis``.  ``b_shape`` is the local
    right-hand side's shape."""

    def inner(x, y):
        return mesh.all_reduce(torch.sum(x.conj() * y, dim=0), axis)

    return inner


def psum_fused_inner(mesh, axis=ROWS, vector_ndim=1):
    """Fused multi-inner-product: ONE ``all_reduce`` for a whole tuple of
    pairs (the ``fused_inner`` injection point of pipelined CG).
    Contracts the first ``vector_ndim`` axes (1 for flat vectors, 2 for
    grid-shaped), so blocked multi-RHS solves keep their per-column
    scalars."""
    dims = tuple(range(vector_ndim))

    def fused(pairs):
        locs = [torch.sum(a.conj() * c, dim=dims) for (a, c) in pairs]
        dt = locs[0].dtype
        for t in locs[1:]:
            dt = torch.promote_types(dt, t.dtype)
        tot = mesh.all_reduce(torch.stack([t.to(dt) for t in locs]), axis)
        return tuple(tot[i] for i in range(len(pairs)))

    return fused


def psum_batch_inner(mesh, axis=ROWS, vector_ndim=1):
    """Batched basis-against-vector inner: ONE ``all_reduce`` per sweep
    (the ``batch_inner`` injection point of GMRES's ``ortho="cgs"``).
    Contracts the stacked ``(K+1, n_local, *tail)`` basis against one local
    vector; ``vector_ndim=2`` contracts grid-shaped vectors."""
    eq = "kmn...,mn...->k..." if vector_ndim == 2 else "kn...,n...->k..."

    def batch(Vb, w):
        return mesh.all_reduce(torch.einsum(eq, Vb.conj(), w), axis)

    return batch


def psum_block_inner(mesh, axis=ROWS):
    """Mesh-aware ``(k, k)`` block inner product: one ``all_reduce`` per
    contraction (the ``block_inner`` injection point of block CG)."""

    def block(U, V):
        return mesh.all_reduce(torch.einsum("...k,...l->kl", U.conj(), V), axis)

    return block
