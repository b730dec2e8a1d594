"""The training step (counterpart of
``repro.distributed.stepfn.make_train_step`` under the ``dp`` strategy).

``step(params, opt_state, batch) -> (params, opt_state, metrics)`` on the
``data`` axis of a process-group layout (``core/hvd.py``), at every world
size: rank r of N takes rows ``[r B/N, (r+1) B/N)`` of the global batch,
the value and gradient of the loss with respect to every parameter leaf
(accumulated over microbatches in f32), the gradients averaged over the
axis by ``hvd.allreduce``, then the optimizer's update on every rank (in
place for AdamW).  Params are nested dicts of f32 master tensors (the
reference's ``param_dtype``); compute runs in the config's dtype.  Sharded
strategies (``dp_tp``, ``fsdp_tp``) wait for ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import optim
from repro_torch.models import transformer as T
from repro_torch.optim import tree_map


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


def make_train_step(cfg, optimizer, groups, *, loss_variant: str = "plain",
                    seq_chunk: int = 512, microbatches: int = 1,
                    device="cuda"):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the ``dp`` strategy on the ``data`` axis of ``groups`` (an
    ``hvd.axis_groups`` layout, made inside ``hvd.init``).

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
    functionally and returns new trees."""
    from repro_torch.core import hvd        # hvd imports this module
    from repro_torch.serving.engine import resolve_device

    device = resolve_device(device)
    if loss_variant not in ("plain", "chunked_ce"):
        raise ValueError(f"unknown loss_variant {loss_variant!r}")
    data = groups["data"]

    def loss_fn(p, b):
        if loss_variant == "chunked_ce":
            return T.lm_loss_chunked(p, cfg, b, seq_chunk=seq_chunk)
        return T.lm_loss(p, cfg, b)

    def step(params, opt_state, batch: Dict[str, Any]):
        B = batch["tokens"].shape[0]
        if B % (data.size * microbatches) != 0:
            raise ValueError(f"global batch {B} is not a multiple of the "
                             f"data axis {data.size} x microbatches "
                             f"{microbatches}")
        n = B // data.size
        batch = {k: torch.as_tensor(_rows(k, v, data.rank * n, n)).to(device)
                 for k, v in batch.items()}
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            n //= microbatches
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
            metrics = tree_map(lambda *a: torch.stack(a).mean(), ms[0],
                               *ms[1:])
        # rebinding ``grads`` frees the rank's own gradients before the
        # update (held through it, they would be a second copy of every
        # gradient at the optimizer's peak)
        grads = hvd.allreduce(grads, data, average=True)
        grad_norm = optim.global_norm(grads)
        if optimizer.update_in_place is not None:
            optimizer.update_in_place(grads, opt_state, params)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        metrics = hvd.allreduce(dict(metrics, loss=loss), data)
        return params, opt_state, dict(metrics, grad_norm=grad_norm)

    return step
