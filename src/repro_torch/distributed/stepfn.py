"""The training step on one device (counterpart of
``repro.distributed.stepfn.make_train_step`` under the ``dp`` strategy on a
one-device mesh).

``step(params, opt_state, batch) -> (params, opt_state, metrics)``: value
and gradient of the loss with respect to every parameter leaf, gradient
accumulation over microbatches in f32, the optimizer's update, then
``apply_updates``.  Params are nested dicts of f32 master tensors (the
reference's ``param_dtype``); compute runs in the config's dtype.  Sharded
strategies (``dp_tp``, ``fsdp_tp``) wait for ROADMAP Queue 1 item 10.
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


def make_train_step(cfg, optimizer, *, loss_variant: str = "plain",
                    seq_chunk: int = 512, microbatches: int = 1,
                    device="cuda"):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    loss_variant: "plain" (``lm_loss``) | "chunked_ce" (``lm_loss_chunked``,
    no (B, S, V) logits).  microbatches > 1 splits the batch along its
    leading dim and accumulates ``grad / microbatches`` in f32 (the same
    update for a token-mean loss).  ``batch`` is a dict of numpy arrays or
    tensors; it is moved to ``device`` (default ``cuda``, which raises
    without a card).  metrics: the loss's metrics (averaged over
    microbatches), ``loss``, and ``grad_norm`` (the global norm of the
    gradient before clipping)."""
    from repro_torch.serving.engine import resolve_device

    device = resolve_device(device)
    if loss_variant not in ("plain", "chunked_ce"):
        raise ValueError(f"unknown loss_variant {loss_variant!r}")

    def loss_fn(p, b):
        if loss_variant == "chunked_ce":
            return T.lm_loss_chunked(p, cfg, b, seq_chunk=seq_chunk)
        return T.lm_loss(p, cfg, b)

    def step(params, opt_state, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches != 0:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatches {microbatches}")
            n = B // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            ms = []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_, m, g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, gi: a + gi.float() / microbatches,
                                 grads, g)
                loss = loss + l_ / microbatches
                ms.append(m)
            metrics = tree_map(lambda *a: torch.stack(a).mean(), ms[0],
                               *ms[1:])
        grad_norm = optim.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss,
                                       grad_norm=grad_norm)

    return step
