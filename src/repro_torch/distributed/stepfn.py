"""The step builders by input shape (counterpart of
``repro.distributed.stepfn``): the training step under the reference's
three strategies (``distributed.sharding``), the prefill step (the
full-sequence forward that emits only the last position's logits) and
the serve step (one token against a ``seq_len`` cache, written in place),
and :func:`make_step_for_shape`, which picks one for a
``configs.base.SHAPES`` entry.

``step(params, opt_state, batch) -> (params, opt_state, metrics)`` on a
process-group layout (``core/hvd.py``; ``launch.mesh``), at every world
size.  ``dp``: rank r of N on the ``data`` axis takes rows ``[r B/N,
(r+1) B/N)`` of the global batch, the value and gradient of the loss with
respect to every parameter leaf (accumulated over microbatches in f32),
the gradients averaged over the axis by ``hvd.allreduce``, then the
optimizer's update on every rank (in place for AdamW).  ``dp_tp`` /
``fsdp_tp`` on a ``(data, model)`` (or ``(pod, data, model)``) mesh: the
params and the optimizer state are this rank's shards (``sharding.
params_pspec``, ``opt_state_pspec``; ``sharding.shard`` cuts them from
full trees), the batch splits over the data axes only (``batch_pspec``),
the model runs tensor-parallel over ``model`` (``models/modules.py``),
and under ``fsdp_tp`` each layer group's params are all-gathered over
``data`` just before use and their gradients reduce-scattered.  Params
are nested dicts of f32 master tensors (the reference's ``param_dtype``);
compute runs in the config's dtype.

Under the span recorder (``core/spans.py``: while a ``torch.profiler``
session records) a train step is three spans, each a device unit with CUDA
events at its edges: ``train.grads`` (the loss and its gradients),
``train.reduce`` (the gradients' all_reduce and the global norm) and
``train.update`` (the optimizer).  The step runs ahead of the device, so
each unit's elapsed time is the device time of its phase; the step settles
the units that have completed, without waiting.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import optim
from repro_torch.core.spans import SPANS
from repro_torch.distributed import sharding as sh
from repro_torch.models import modules as nn
from repro_torch.models import transformer as T
from repro_torch.optim import tree_map


def params_struct(cfg):
    """The f32 params tree on the ``meta`` device: shapes and dtypes, no
    memory (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return T.init_params(cfg, torch.Generator(), device="meta",
                         weight_dtype=torch.float32)


def opt_state_struct(cfg, optimizer):
    """The optimizer's state over :func:`params_struct`, on ``meta``."""
    return optimizer.init(params_struct(cfg))


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``; grads share
    ``params``' structure and dtypes.  The params themselves are not
    modified (gradients go to detached aliases)."""
    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    p = tree_map(alias, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    metrics = tree_map(lambda m: m.detach(), metrics)
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


# batch keys whose batch axis is not the leading one: M-RoPE positions
# are (3, B, S) (the reference pins their batch to the data axis on dim 1)
_BATCH_AXIS = {"mrope_positions": 1}


def _rows(key, v, start: int, n: int):
    """Rows ``[start, start + n)`` of batch entry ``key`` along its batch
    axis."""
    ax = _BATCH_AXIS.get(key, 0)
    return v[(slice(None),) * ax + (slice(start, start + n),)]


def _grads(loss_fn, params, batch, microbatches: int, device):
    """(loss, metrics, grads) of this rank's rows ``batch``, accumulated
    over ``microbatches`` splits of them along each entry's batch axis
    (``grad / microbatches`` summed in f32, the metrics and loss
    averaged)."""
    if microbatches == 1:
        return value_and_grad(loss_fn, params, batch)
    n = batch["tokens"].shape[0] // microbatches
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32, device=device)
    ms = []
    for i in range(microbatches):
        mb = {k: _rows(k, v, i * n, n) for k, v in batch.items()}
        l_, m, g = value_and_grad(loss_fn, params, mb)
        grads = tree_map(lambda a, gi: a + gi.float() / microbatches,
                         grads, g)
        loss = loss + l_ / microbatches
        ms.append(m)
    metrics = tree_map(lambda *a: torch.stack(a).mean(), ms[0], *ms[1:])
    return loss, metrics, grads


def make_train_step(cfg, optimizer, groups, *, strategy: str = "dp",
                    loss_variant: str = "plain", seq_chunk: int = 512,
                    microbatches: int = 1, device="cuda",
                    long_context: bool = False, local_rows: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` under ``strategy`` on ``groups`` (an ``hvd.axis_groups``
    layout, made inside ``hvd.init``; ``launch.mesh.make_mesh``).  ``dp``
    uses its ``data`` axis; ``dp_tp`` and ``fsdp_tp`` need a ``model``
    axis too and are :func:`make_sharded_train_step`'s.

    ``batch`` is the whole global batch, as every rank draws it (a dict of
    numpy arrays or tensors); this rank's rows of it are moved to
    ``device`` (default ``cuda``, which raises without a card).
    loss_variant: "plain" (``lm_loss``) | "chunked_ce" (``lm_loss_chunked``,
    no (B, S, V) logits).  Every batch entry is split along its batch
    axis: the leading one, but axis 1 of ``mrope_positions`` (3, B, S).
    microbatches > 1 splits the rank's rows along that axis and
    accumulates ``grad / microbatches`` in f32 (the same update for a
    token-mean loss).  The gradients are averaged over
    the axis by one fused all_reduce per dtype, issued at world size 1
    too; with equal token counts on every shard the mean of the shard
    means is the global token mean, so this is the reference's ``dp`` step
    on a mesh's data axis.  metrics: the loss's metrics and ``loss``
    (averaged over microbatches, then over the axis by one more
    all_reduce), and ``grad_norm`` (the global norm of the averaged
    gradient before clipping).

    The update is made in place where the optimizer can (AdamW's
    ``update_in_place``, leaf by leaf, the same bits as its functional
    ``update``), as the reference's step donates its params and optimizer
    state (``donate_argnums=(0, 1)``): the step then returns the objects it
    was given, updated, and holds one copy of the params and the optimizer
    state instead of two (~20 bytes a parameter at its peak rather than
    ~36: params, AdamW state, the gradients and their fused all_reduce
    buffer, all f32), which is what lets a full-width qwen2-vl-72b layer
    train on one card.  An optimizer without one (SGD, RMSProp) updates
    functionally and returns new trees.

    ``long_context``: the losses' (``transformer.layer_pattern``).
    ``local_rows``: the step takes this rank's rows, already cut and on
    the device (:func:`make_step_for_shape`'s convention), in place of
    the global batch."""
    from repro_torch.core import hvd        # hvd imports this module
    from repro_torch.serving.engine import resolve_device

    if strategy != "dp":
        return make_sharded_train_step(
            cfg, optimizer, groups, strategy=strategy,
            loss_variant=loss_variant, seq_chunk=seq_chunk,
            microbatches=microbatches, device=device,
            long_context=long_context, local_rows=local_rows)
    device = resolve_device(device)
    data = groups["data"]
    loss_fn = _loss_fn(cfg, loss_variant, seq_chunk, long_context)

    def step(params, opt_state, batch: Dict[str, Any]):
        B = batch["tokens"].shape[0]
        if B % (data.size * microbatches) != 0:
            raise ValueError(f"global batch {B} is not a multiple of the "
                             f"data axis {data.size} x microbatches "
                             f"{microbatches}")
        n = B // data.size
        return local(params, opt_state, {
            k: torch.as_tensor(_rows(k, v, data.rank * n, n)).to(device)
            for k, v in batch.items()})

    def local(params, opt_state, batch: Dict[str, Any]):
        with SPANS.span("train.grads", device=device):
            loss, metrics, grads = _grads(loss_fn, params, batch,
                                          microbatches, device)
        with SPANS.span("train.reduce", device=device):
            # rebinding ``grads`` frees the rank's own gradients before
            # the update (held through it, they would be a second copy of
            # every gradient at the optimizer's peak)
            grads = hvd.allreduce(grads, data, average=True)
            grad_norm = optim.global_norm(grads)
        with SPANS.span("train.update", device=device):
            if optimizer.update_in_place is not None:
                optimizer.update_in_place(grads, opt_state, params)
            else:
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = optim.apply_updates(params, updates)
        metrics = hvd.allreduce(dict(metrics, loss=loss), data)
        SPANS.settle()
        return params, opt_state, dict(metrics, grad_norm=grad_norm)

    return local if local_rows else step


def _loss_fn(cfg, loss_variant: str, seq_chunk: int, long_context: bool,
             shards=None):
    """``loss_fn(p, b)`` of ``loss_variant``: "plain" (``lm_loss``) or
    "chunked_ce" (``lm_loss_chunked`` at ``seq_chunk``), tensor parallel
    under ``shards``."""
    if loss_variant == "chunked_ce":
        return lambda p, b: T.lm_loss_chunked(
            p, cfg, b, shards, seq_chunk=seq_chunk,
            long_context=long_context)
    if loss_variant != "plain":
        raise ValueError(f"unknown loss_variant {loss_variant!r}")
    return lambda p, b: T.lm_loss(p, cfg, b, shards,
                                  long_context=long_context)


# ---------------------------------------------------------------------------
# dp_tp / fsdp_tp
# ---------------------------------------------------------------------------

def make_sharded_train_step(cfg, optimizer, groups, *, strategy: str,
                            loss_variant: str = "plain",
                            seq_chunk: int = 512,
                            microbatches: int = 1, device="cuda",
                            long_context: bool = False,
                            local_rows: bool = False):
    """The ``dp_tp`` / ``fsdp_tp`` step on ``groups`` (axes ``data`` and
    ``model``, optionally ``pod`` before them).  ``params`` and
    ``opt_state`` are this rank's shards (``shard_state``); ``batch`` is
    the whole global batch as every rank draws it, of which this rank
    takes the rows of its data coordinate (``sharding.batch_pspec``: the
    whole batch where it does not split).

    Gradients: a leaf split over ``data`` (``fsdp_tp``) arrives summed
    over the data ranks by its all_gather's backward reduce_scatter; every
    other leaf is all_reduced (one fused buffer per dtype and set of axes)
    over the data axes it is replicated on; each is then divided by the
    data axes' size, the mean over the global batch.  A leaf replicated
    over ``model`` gets the same whole gradient on every model rank
    (Megatron's f and g put the all_reduces there).  The clipping norm is
    the global norm over every rank's shards: each leaf's sum of squares
    counted on the ranks at coordinate 0 of the axes it is replicated
    over, all_reduced over the world.  AdamW updates in place
    (``update_in_place``), shard by shard.  metrics: ``loss`` and the
    loss's metrics averaged over the data axes, ``grad_norm``.
    ``loss_variant``, ``seq_chunk``, ``microbatches``, ``local_rows``: as
    :func:`make_train_step`'s; the chunked loss is vocab-parallel as the
    plain one is (``transformer.lm_loss_chunked``)."""
    from repro_torch.core import hvd
    from repro_torch.serving.engine import resolve_device

    if strategy not in ("dp_tp", "fsdp_tp"):
        raise ValueError(f"unknown sharded strategy {strategy!r}")
    if "model" not in groups.axis_names:
        raise ValueError(f"{strategy} needs a 'model' axis; the layout has "
                         f"{groups.axis_names}")
    device = resolve_device(device)
    shards = train_shards(cfg, groups, strategy)
    specs, dgroup = shards.specs, shards.batch
    daxes = sh.data_axes(groups)
    loss_fn = _loss_fn(cfg, loss_variant, seq_chunk, long_context, shards)

    def rows(batch):
        """This rank's rows of the global batch (``batch_pspec``)."""
        from repro_torch.configs.base import InputShape
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        B, S = batch["tokens"].shape
        bspec = sh.batch_pspec(batch, groups, cfg,
                               InputShape("train", S, B, "train"), strategy)
        return {k: v.to(device)
                for k, v in sh.shard(batch, bspec, groups).items()}

    def reduce_grads(grads):
        by_axes = {}
        for path, (g, spec) in _flat(grads, specs).items():
            rest = tuple(a for a in daxes if a not in sh.axes_of(spec))
            by_axes.setdefault(rest, {})[path] = g
        out = {}
        for rest, tree in by_axes.items():
            if rest:
                tree = hvd.allreduce(tree, groups[rest], average=False)
            out.update(tree)
        for g in out.values():
            g.div_(dgroup.size)
        return _unflat(out, grads)

    def global_norm(grads):
        sq = [torch.sum(torch.square(g.float())) for g, spec in
              zip(optim.leaves(grads), optim.leaves(specs))
              if all(groups[a].rank == 0 for a in groups.axis_names
                     if a not in sh.axes_of(spec))]
        total = (sum(sq) if sq else
                 torch.zeros((), dtype=torch.float32, device=device))
        return torch.sqrt(hvd.allreduce(total, groups.world, average=False))

    def step(params, opt_state, batch: Dict[str, Any]):
        return local(params, opt_state, rows(batch))

    def local(params, opt_state, batch: Dict[str, Any]):
        n = batch["tokens"].shape[0]
        if n % microbatches:
            raise ValueError(f"{n} rows a rank are not a multiple of "
                             f"microbatches {microbatches}")
        with SPANS.span("train.grads", device=device):
            loss, metrics, grads = _grads(loss_fn, params, batch,
                                          microbatches, device)
        with SPANS.span("train.reduce", device=device):
            grads = reduce_grads(grads)
            grad_norm = global_norm(grads)
        with SPANS.span("train.update", device=device):
            if optimizer.update_in_place is not None:
                optimizer.update_in_place(grads, opt_state, params,
                                          norm=grad_norm)
            else:
                updates, opt_state = optimizer.update(
                    grads, opt_state, params, norm=grad_norm)
                params = optim.apply_updates(params, updates)
        metrics = hvd.allreduce(dict(metrics, loss=loss), dgroup)
        SPANS.settle()
        return params, opt_state, dict(metrics, grad_norm=grad_norm)

    step.specs = specs
    return local if local_rows else step


def train_shards(cfg, groups, strategy: str):
    """The ``modules.Shards`` the train step under ``strategy`` runs its
    loss with: None under ``dp``; else this rank's params' specs over
    ``model`` (and ``data`` under ``fsdp_tp``), with the data axes' group
    for statistics of the whole global batch."""
    if strategy == "dp":
        return None
    specs = sh.params_pspec(params_struct(cfg), cfg, strategy, groups)
    return nn.Shards(specs, groups["model"],
                     groups["data"] if strategy == "fsdp_tp" else None,
                     batch=groups[sh.data_axes(groups)])


def _flat(tree, specs, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, specs[k], path))
        else:
            out[path] = (v, specs[k])
    return out


def _unflat(flat, like, prefix=""):
    return {k: (_unflat(flat, v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else
                flat[f"{prefix}/{k}" if prefix else k])
            for k, v in like.items()}


def state_specs(cfg, optimizer, strategy: str, groups):
    """(param specs, optimizer-state specs) of ``cfg`` under ``strategy``
    on ``groups``."""
    pstruct = params_struct(cfg)
    pspec = sh.params_pspec(pstruct, cfg, strategy, groups)
    ostruct = optimizer.init(pstruct)
    return pspec, sh.opt_state_pspec(ostruct, pspec)


def shard_state(params, cfg, optimizer, strategy: str, groups):
    """This rank's shards of full ``params`` and a fresh optimizer state
    over them: ``(params, opt_state)``."""
    pspec, _ = state_specs(cfg, optimizer, strategy, groups)
    local = sh.shard(params, pspec, groups)
    return local, optimizer.init(local)


# ---------------------------------------------------------------------------
# Prefill and serve steps (inference)
# ---------------------------------------------------------------------------

def _inference_shards(cfg, groups, strategy: str, cache_specs=None):
    """The ``modules.Shards`` an inference step runs its layers with:
    None under ``dp`` (every rank holds the whole model and its own rows),
    else this rank's params' specs over ``model`` (and ``data`` under
    ``fsdp_tp``), with no batch group (no statistic of the batch is
    taken) and the cache's specs for the serve step."""
    if strategy == "dp":
        if groups.shape.get("model", 1) != 1:
            raise NotImplementedError(
                "an inference step under dp runs on a layout whose model "
                "axis is 1")
        return None
    if strategy not in ("dp_tp", "fsdp_tp"):
        raise ValueError(f"unknown strategy {strategy!r}")
    specs = sh.params_pspec(params_struct(cfg), cfg, strategy, groups)
    return nn.Shards(specs, groups["model"],
                     groups["data"] if strategy == "fsdp_tp" else None,
                     groups=groups, cache=cache_specs)


def _batch_specs(cfg, groups, strategy: str, shape):
    from repro_torch.configs.base import input_specs
    return sh.batch_pspec(input_specs(cfg, shape), groups, cfg, shape,
                          strategy)


def make_prefill_step(cfg, groups, strategy: str, shape, *,
                      long_context: bool = False, device="cuda"):
    """``step(params, batch) -> logits (b, 1, V) f32``: the full-sequence
    forward of this rank's rows, unembedding only the last position
    (``forward(last_only=True)``), under ``torch.no_grad``, tensor
    parallel where ``strategy`` shards (``dp_tp`` / ``fsdp_tp``), the
    vocabulary's slices all-gathered so every rank holds whole logits.
    ``params`` are this rank's shards, ``batch`` its rows (cut from the
    global batch by ``sharding.batch_pspec``, the ``specs`` that
    :func:`make_step_for_shape` returns); the batch is moved to
    ``device``."""
    from repro_torch.serving.engine import resolve_device
    device = resolve_device(device)
    shards = _inference_shards(cfg, groups, strategy)

    def step(params, batch):
        batch = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            logits, _ = T.forward(params, cfg, batch, last_only=True,
                                  shards=shards, long_context=long_context)
            return T.gather_vocab(cfg, logits, shards)

    return step


def make_serve_step(cfg, groups, strategy: str, shape, *,
                    long_context: bool = False, device="cuda"):
    """``step(params, batch) -> (logits (b, 1, V) f32, cache)``: one
    token per row against a ``shape.seq_len`` dense cache
    (``transformer.decode_step``), the cache written in place (the
    reference donates it, ``donate_argnums=(1,)``: one copy of it is
    held).  ``params`` are this rank's shards; ``batch`` holds this
    rank's rows of tokens and positions and its shard of the cache by
    ``sharding.batch_pspec`` (the ``specs`` that
    :func:`make_step_for_shape` returns), whose layout the attention follows (heads over
    ``model``, the sequence over a group, or whole); the logits are whole
    on every rank.  Tokens and positions are moved to ``device``; the
    cache must be there."""
    from repro_torch.serving.engine import resolve_device
    device = resolve_device(device)
    bspec = _batch_specs(cfg, groups, strategy, shape)
    shards = _inference_shards(cfg, groups, strategy, bspec["cache"])

    def step(params, batch):
        batch = {k: (v if k == "cache" else v.to(device))
                 for k, v in batch.items()}
        return T.decode_step(params, cfg, batch, shards=shards,
                             long_context=long_context)

    return step


def make_step_for_shape(cfg, groups, strategy: str, shape, optimizer=None,
                        *, device="cuda", **train_kw):
    """The step of ``shape``'s kind (``configs.base.SHAPES``) and the
    structs of its arguments: ``(step, structs)``.  ``long_context`` is
    set exactly for ``long_500k``.  Every step takes this rank's rows
    (and cache shard), cut from the global batch by ``structs["specs"]
    ["batch"]``.  train: ``step(params, opt_state, batch)``
    (``make_train_step`` with ``local_rows``), AdamW at 1e-4 unless
    ``optimizer`` is given, and ``train_kw`` (``loss_variant``,
    ``seq_chunk``, ``microbatches``) passed to it, as the reference's
    hill-climb passes its ``step_kw``; prefill: ``step(params, batch)``;
    decode: the serve step.  ``structs``: this rank's local
    ``params``, ``opt_state`` (train only) and ``batch`` as ``meta``
    tensors, cut by the specs, and their ``specs``."""
    from repro_torch.configs.base import input_specs
    long_context = shape.name == "long_500k"
    pstruct = params_struct(cfg)
    pspec = sh.params_pspec(pstruct, cfg, strategy, groups)
    bstruct = input_specs(cfg, shape)
    bspec = _batch_specs(cfg, groups, strategy, shape)
    mesh = groups.shape
    structs = {"params": _local_meta(pstruct, pspec, mesh),
               "batch": _local_meta(bstruct, bspec, mesh),
               "specs": {"params": pspec, "batch": bspec}}
    if shape.kind == "train":
        optimizer = optimizer or optim.adamw(1e-4)
        ostruct = optimizer.init(pstruct)
        ospec = sh.opt_state_pspec(ostruct, pspec)
        structs["opt_state"] = _local_meta(ostruct, ospec, mesh)
        structs["specs"]["opt_state"] = ospec
        return make_train_step(cfg, optimizer, groups, strategy=strategy,
                               device=device, long_context=long_context,
                               local_rows=True, **train_kw), structs
    if train_kw:
        raise ValueError(f"{sorted(train_kw)} are a train step's options; "
                         f"{shape.name} is a {shape.kind} step")
    make = make_prefill_step if shape.kind == "prefill" else make_serve_step
    return make(cfg, groups, strategy, shape, long_context=long_context,
                device=device), structs


def _local_meta(tree, specs, mesh_shape):
    """``meta`` tensors of each leaf's local shape (tensors or ``(shape,
    dtype)`` pairs)."""
    if isinstance(tree, dict):
        return {k: _local_meta(v, specs[k], mesh_shape)
                for k, v in tree.items()}
    shape, dtype = ((tree[0], tree[1]) if isinstance(tree, tuple)
                    else (tuple(tree.shape), tree.dtype))
    return torch.empty(sh.local_shape(specs, tuple(shape), mesh_shape),
                       dtype=dtype, device="meta")
