"""Horovod-style data parallelism on ``torch.distributed`` — the paper's
§II-H (counterpart of ``repro.core.hvd``).

The paper's recipe: take a single-process script, add four calls
(``hvd.init()``, pin one rank per device, average the gradients before
the optimizer's update, broadcast the initial variables) and run it under
``mpiexec``.  Here ``torchrun`` is the ``mpiexec``: it sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the store's address, and :func:`init`
reads them; :func:`run_ranks` starts the ranks of a ``python -c`` program
on this host the same way.  Gradients are exchanged by allreduce (NCCL on the card, gloo
on the CPU), contrasted with the parameter-server baseline in
``repro_torch.core.paramserver``.

The reference's mesh axes become process groups: :func:`axis_groups`
lays the world out row-major over a shape such as ``{"pod": 2, "data":
2}`` and gives this rank one :class:`Group` for each set of axes.  Every
collective takes a group and adds what this rank hands it (calls and
bytes) to that group's counters, as the kernels' wrappers count their
launches.  The collectives run whatever the group's size: at world size 1
they are still issued.

A step is Horovod's contract: parameters and optimizer state replicated,
each rank passes its own shard of the batch, gradients averaged, the same
update applied everywhere, so the replicas stay identical bit for bit.

The sharded strategies (``dp_tp``, ``fsdp_tp``: ``distributed/stepfn.py``)
run collectives inside the model, as autograd Functions that count
forward and backward alike: FSDP's :func:`all_gather_dim` (backward a
reduce_scatter) and :func:`reduce_scatter_dim` over ``data``; Megatron's
:func:`copy_to_group` (f), :func:`reduce_from_group` (g),
:func:`scatter_to_group` and :func:`gather_from_group` over ``model``;
:func:`mean_over_group` for a statistic of the whole global batch.  This
module stays the port's one entry to ``torch.distributed``.

:func:`abstract_groups` lays out a world that does not exist (the dry-run's
production meshes, ``launch/dryrun.py``): one rank's groups with their
rank lists and no process group.  Every collective counts on them exactly
as on a real group and returns an output of the right shape without
communicating; they take ``meta`` tensors only.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import shutil
import subprocess
import sys
import tempfile
from typing import (Callable, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.distributed.stepfn import value_and_grad
from repro_torch.optim import tree_map

# torch >= 2.13 names these ``*_single`` and deprecates the older names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


# ---------------------------------------------------------------------------
# The process group (hvd.init)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def init(device, init_method: Optional[str] = None
         ) -> Iterator[torch.device]:
    """Create the default process group for ``device`` and yield this
    rank's device; the group is destroyed when the block ends.

    NCCL when the device is ``cuda`` (one card a rank, ``LOCAL_RANK``),
    gloo when it is ``cpu``; never the other.  Rank and world size come
    from ``RANK`` / ``WORLD_SIZE`` (set by ``torchrun``); the store from
    ``init_method``, else ``env://``.  With no ``RANK`` set it runs alone
    (world size 1) on a ``file://`` store in a temporary directory.  Inside
    a block that already made a group of the same backend, it yields that
    group's device and leaves the group to its maker."""
    dev = torch.device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    backend = _BACKENDS[dev.type]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' explicitly to train on gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group "
                               f"exists; device {dev} needs {backend}")
        yield dev
        return
    store_dir = None
    if "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    else:
        rank, world = 0, 1
        if init_method is None:
            store_dir = tempfile.mkdtemp(prefix="hvd-store-")
            init_method = f"file://{os.path.join(store_dir, 'store')}"
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        yield dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


class DeviceCountError(ValueError):
    """More NCCL ranks asked for than this host has cards: NCCL needs one
    card a rank."""


def run_ranks(prog: str, world: int, out, *args: str, device="cpu",
              timeout: float = 240.0) -> None:
    """Run ``prog`` (the text of a ``python -c`` program) as ``world`` ranks
    on this host, as ``mpiexec`` or ``torchrun`` would: each rank gets
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and the arguments
    ``<store> <out> *args``, where ``<store>`` is a ``file://`` store in
    the directory ``out`` (no network) for :func:`init`'s
    ``init_method``.  ``device`` is the one the program passes to
    :func:`init`: on ``cuda`` every rank needs a card of its own.  Raises
    ``RuntimeError`` with the tail of every failed rank's stderr."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' explicitly to run the ranks on gloo")
        if world > torch.cuda.device_count():
            raise DeviceCountError(
                f"{world} NCCL ranks need {world} cards; this host has "
                f"{torch.cuda.device_count()} (pass device='cpu' for gloo)")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=src, WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    store = f"file://{os.path.join(str(out), 'store')}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, store, str(out), *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"rank {r} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))


# ---------------------------------------------------------------------------
# Groups: the mesh axes
# ---------------------------------------------------------------------------

ABSTRACT = object()     # the process group of an abstract layout's groups


class Group:
    """This rank's communicator over some axes of the layout, with the
    counts of what this rank handed its collectives: in all (``calls``,
    ``bytes``) and by kind of collective (``kinds``).  ``pg`` is
    :data:`ABSTRACT` for a group of :func:`abstract_groups`, whose world
    rank ``me`` is given."""

    def __init__(self, axes: Tuple[str, ...], ranks: List[int], pg,
                 me: Optional[int] = None):
        self.axes, self.ranks, self.pg = axes, ranks, pg
        self.size = len(ranks)
        self.rank = ranks.index(dist.get_rank() if me is None else me)
        self.reset()

    def live(self, *ts: torch.Tensor) -> bool:
        """Whether a collective on ``ts`` communicates: always on a real
        group; never on an abstract one, which takes ``meta`` tensors
        only and raises on any other."""
        if self.pg is not ABSTRACT:
            return True
        for t in ts:
            if t.device.type != "meta":
                raise ValueError(
                    f"an abstract group ({self.axes}) takes meta tensors "
                    f"only, got one on {t.device}")
        return False

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.kinds: Dict[str, List[int]] = {}

    def count(self, t: torch.Tensor, kind: str) -> None:
        n = t.numel() * t.element_size()
        self.calls += 1
        self.bytes += n
        k = self.kinds.setdefault(kind, [0, 0])
        k[0] += 1
        k[1] += n

    def output_bytes(self) -> int:
        """The bytes of every collective's output since the last reset,
        the measure of the reference's ``launch.dryrun.collective_bytes``
        (each collective's output shape in the compiled program): an
        all_gather gives ``size`` x what it was handed, a reduce_scatter
        1 / ``size``, an all_reduce or a broadcast as much."""
        return sum(self.output_bytes_by_kind().values())

    def output_bytes_by_kind(self) -> Dict[str, int]:
        """:meth:`output_bytes` by kind of collective."""
        scale = {"all_gather": self.size, "reduce_scatter": 1 / self.size}
        return {kind: int(n * scale.get(kind, 1))
                for kind, (_, n) in self.kinds.items()}


class Groups:
    """This rank's :class:`Group` for every non-empty set of axes of a
    row-major layout (``groups["data"]``, ``groups[("pod", "data")]``);
    ``world`` spans every axis."""

    def __init__(self, axes: Tuple[str, ...], groups: Dict[tuple, Group]):
        self.axes, self._groups = axes, groups

    def __getitem__(self, axes: Union[str, Sequence[str]]) -> Group:
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[tuple(a for a in self.axes if a in key)]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``: the layout read as a mesh
        (``distributed.sharding`` takes it as one)."""
        return {a: self[a].size for a in self.axes}

    @property
    def world(self) -> Group:
        return self[self.axes]

    def counts(self) -> Dict[Tuple[str, ...], Tuple[int, int]]:
        """``{axes: (calls, bytes)}`` since the last reset."""
        return {k: (g.calls, g.bytes) for k, g in self._groups.items()}

    def reset_counts(self) -> None:
        for g in self._groups.values():
            g.reset()


def _layout(shape: Dict[str, int], me: int, new_group) -> Groups:
    """Rank ``me``'s group for each set of axes of the row-major layout
    ``shape``.  ``new_group(ranks)`` makes each group's process group
    (called for every group of the world, in one order); None makes
    :data:`ABSTRACT` groups, this rank's alone."""
    sizes = list(shape.values())
    coords = list(itertools.product(*(range(s) for s in sizes)))
    mine = coords[me]
    names = list(shape)
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            free = [names.index(a) for a in axes]

            def key(c):
                return tuple(c[i] for i in range(len(c)) if i not in free)

            for fixed in (sorted({key(c) for c in coords})
                          if new_group else [key(mine)]):
                ranks = [r for r, c in enumerate(coords) if key(c) == fixed]
                pg = new_group(ranks) if new_group else ABSTRACT
                if key(mine) == fixed:
                    groups[axes] = Group(axes, ranks, pg, me)
    return Groups(tuple(names), groups)


def axis_groups(shape: Dict[str, int]) -> Groups:
    """Lay the world out row-major over ``shape`` (the last axis fastest,
    like MPI ranks on a Cartesian communicator) and make this rank's group
    for each set of axes.  Every rank makes every group, in one order, as
    ``dist.new_group`` requires."""
    n = 1
    for s in shape.values():
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"layout {shape} holds {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    return _layout(shape, dist.get_rank(), dist.new_group)


def abstract_groups(shape: Dict[str, int], rank: int = 0) -> Groups:
    """Rank ``rank``'s groups of the row-major layout ``shape``, for every
    set of axes, with their ``ranks`` lists and no process group (no
    ``init_process_group``, at any size).  Their collectives count as on
    real groups and return outputs of the right shape, on ``meta``
    tensors only (``Group.live``)."""
    n = 1
    for s in shape.values():
        n *= s
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside the layout {shape}")
    return _layout(shape, rank, None)


def rank(group: Group) -> int:
    """This rank's index in ``group`` (row-major over its axes, like
    ``MPI_Comm_rank``)."""
    return group.rank


def size(group: Group) -> int:
    return group.size


# ---------------------------------------------------------------------------
# Collectives (Horovod vocabulary)
# ---------------------------------------------------------------------------

def _leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves in ``tree_map``'s order (dict insertion order)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _fused(tree, op: Callable[[torch.Tensor], torch.Tensor]):
    """Horovod's tensor fusion: the leaves of each dtype packed into one
    contiguous buffer, ``op`` applied to each buffer once, the result cut
    back into the tree's shapes."""
    leaves = list(_leaves(tree))
    out: List[torch.Tensor] = [None] * len(leaves)
    dtypes = sorted({t.dtype for t in leaves}, key=str)
    for dt in dtypes:
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        buf = op(torch.cat([leaves[i].reshape(-1) for i in idx]))
        parts = torch.split(buf, [leaves[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def _mean_dtype_check(buf: torch.Tensor) -> None:
    if not buf.is_floating_point():
        raise TypeError(f"averaging needs floating leaves, got {buf.dtype}")


def allreduce(tree, group: Group, average: bool = True):
    """Sum (``average``: mean) of every leaf over ``group``: one
    ``all_reduce`` per dtype of the tree."""
    def op(buf):
        if average:
            _mean_dtype_check(buf)
        group.count(buf, "all_reduce")
        if group.live(buf):
            dist.all_reduce(buf, group=group.pg)
        return buf.div_(group.size) if average else buf
    return _fused(tree, op)


def allgather(tree, group: Group):
    """Every leaf concatenated over ``group`` along dim 0 (a 0-d leaf
    becomes a (size,) vector)."""
    def g(t):
        t = t.reshape(1) if t.ndim == 0 else t.contiguous()
        out = t.new_empty((group.size * t.shape[0],) + tuple(t.shape[1:]))
        group.count(t, "all_gather")
        if group.live(t):
            _all_gather(out, t, group=group.pg)
        return out
    return tree_map(g, tree)


def hierarchical_allreduce(tree, inner: Group, outer: Group,
                           average: bool = True):
    """Pod-aware allreduce: reduce-scatter over ``inner`` (intra-pod),
    allreduce the shard over ``outer`` (inter-pod), all-gather back over
    ``inner``; divided once by |inner| x |outer|.  The outer link carries
    1/|inner| of the bytes of a flat allreduce.  Fused per dtype like
    :func:`allreduce`: the buffer is padded to a multiple of |inner|."""
    def op(buf):
        if average:
            _mean_dtype_check(buf)
        n = buf.numel()
        pad = (-n) % inner.size
        if pad:
            buf = torch.cat([buf, buf.new_zeros(pad)])
        shard = buf.new_empty(buf.numel() // inner.size)
        inner.count(buf, "reduce_scatter")
        if inner.live(buf):
            _reduce_scatter(shard, buf, group=inner.pg)
        outer.count(shard, "all_reduce")
        if outer.live(shard):
            dist.all_reduce(shard, group=outer.pg)
        full = torch.empty_like(buf)
        inner.count(shard, "all_gather")
        if inner.live(shard):
            _all_gather(full, shard, group=inner.pg)
        full = full[:n]
        return full.div_(inner.size * outer.size) if average else full
    return _fused(tree, op)


def broadcast(tree, group: Group, root: int = 0):
    """Every leaf as ``group``'s rank ``root`` holds it (Horovod's
    initial-variable broadcast): one ``broadcast`` per dtype."""
    def op(buf):
        group.count(buf, "broadcast")
        if group.live(buf):
            dist.broadcast(buf, src=group.ranks[root], group=group.pg)
        return buf
    return _fused(tree, op)


def all_reduce_max(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (no gradient: the
    vocab-parallel cross-entropy's shift)."""
    t = t.detach().clone()
    group.count(t, "all_reduce")
    if group.live(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
    return t


# ---------------------------------------------------------------------------
# Collectives inside a model, with their gradients: FSDP over ``data``
# (all_gather / reduce_scatter along a dim) and Megatron's tensor
# parallelism over ``model`` (copy_to / reduce_from / scatter_to /
# gather_from).  Each counts what this rank hands it, in the forward and
# in the backward, and runs whatever the group's size.
# ---------------------------------------------------------------------------

def gather_dim(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """``t`` concatenated over ``group`` along ``dim`` (rank order)."""
    t0 = t.movedim(dim, 0).contiguous()
    out = t0.new_empty((group.size * t0.shape[0],) + tuple(t0.shape[1:]))
    group.count(t0, "all_gather")
    if group.live(t0):
        _all_gather(out, t0, group=group.pg)
    return out.movedim(0, dim).contiguous()


def _scatter_dim(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``t`` over
    ``group``."""
    t0 = t.movedim(dim, 0).contiguous()
    if t0.shape[0] % group.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {group.size} ranks")
    out = t0.new_empty((t0.shape[0] // group.size,) + tuple(t0.shape[1:]))
    group.count(t0, "reduce_scatter")
    if group.live(t0):
        _reduce_scatter(out, t0, group=group.pg)
    return out.movedim(0, dim).contiguous()


def _slice_dim(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.rank * n, n).contiguous()


def _sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    t = t.contiguous().clone()
    group.count(t, "all_reduce")
    if group.live(t):
        dist.all_reduce(t, group=group.pg)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, ctx.dim, ctx.group), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t, group).div_(group.size)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group).div_(ctx.group.size), None


def mean_over_group(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of ``t`` over the data ranks of ``group``, inside a loss
    whose gradients the step then averages over the same ranks: a
    statistic of the whole global batch (the MoE aux loss's router
    means).  Backward: the gradients' mean over the group, the adjoint
    when every rank's loss reads the mean."""
    return _MeanOver.apply(t, group)


def all_gather_dim(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """FSDP's gather of a parameter shard: ``t`` concatenated over
    ``group`` along ``dim``.  Backward: the gradient reduce-scattered (each
    rank gets the sum over the group of its shard's gradient)."""
    return _AllGather.apply(t, dim, group)


def reduce_scatter_dim(t: torch.Tensor, dim: int,
                       group: Group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``t`` over ``group``.
    Backward: the gradient all-gathered."""
    return _ReduceScatter.apply(t, dim, group)


def copy_to_group(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's f: a replicated activation entering a sharded region.
    Identity forward; backward, the ranks' partial gradients
    all_reduced."""
    return _CopyTo.apply(t, group)


def reduce_from_group(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's g: the ranks' partial sums all_reduced into the
    replicated value.  Backward: identity."""
    return _ReduceFrom.apply(t, group)


def scatter_to_group(t: torch.Tensor, dim: int,
                     group: Group) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated ``t`` (a row-parallel
    product's input that is whole).  Backward: the slices' gradients
    all-gathered, so the replicated ``t`` gets its whole gradient on every
    rank."""
    return _ScatterTo.apply(t, dim, group)


def gather_from_group(t: torch.Tensor, dim: int,
                      group: Group) -> torch.Tensor:
    """A shard made whole for a replicated computation: ``t`` concatenated
    over ``group`` along ``dim``.  Backward: this rank's slice of the
    (replicated) gradient."""
    return _GatherFrom.apply(t, dim, group)


# ---------------------------------------------------------------------------
# The replicated-DP train step
# ---------------------------------------------------------------------------

def make_train_step(loss_fn: Callable, optimizer: optim.Optimizer,
                    groups: Groups, hierarchical: bool = False) -> Callable:
    """Returns ``step(params, opt_state, *args) -> (params, opt_state,
    metrics)`` over every axis of ``groups``: ``loss_fn(params, *args) ->
    (loss, metrics)`` on this rank's shard, gradients averaged over the
    world, the same update on every rank, the metrics (and ``loss``)
    averaged.

    hierarchical=True on a layout with a ``pod`` axis: gradients take
    :func:`hierarchical_allreduce` (inner = the other axes, outer =
    ``pod``) instead of one flat allreduce."""
    world = groups.world
    inner_axes = tuple(a for a in groups.axes if a != "pod")
    hier = hierarchical and "pod" in groups.axes and inner_axes

    def step(params, opt_state, *args):
        loss, metrics, grads = value_and_grad(
            lambda p, a: loss_fn(p, *a), params, args)
        # rebinding ``grads`` frees the rank's own gradients before the
        # update (held through it, they would be a second copy of every
        # gradient at the optimizer's peak)
        if hier:
            grads = hierarchical_allreduce(grads, groups[inner_axes],
                                           groups["pod"])
        else:
            grads = allreduce(grads, world, average=True)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        metrics = allreduce(dict(metrics, loss=loss), world)
        return params, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable, groups: Groups) -> Callable:
    """``step(params, *args) -> metrics``: ``loss_fn`` on this rank's shard
    without gradients, its metrics and ``loss`` averaged over the world."""
    world = groups.world

    def step(params, *args):
        with torch.no_grad():
            loss, metrics = loss_fn(params, *args)
        return allreduce(dict(metrics, loss=loss), world)

    return step
