"""Parameter-server baseline — the architecture the paper's Horovod
replaces (counterpart of ``repro.core.paramserver``).

TensorFlow's classic distributed mode: workers push gradients to central
parameter servers, which apply the update and serve fresh parameters back.
On a flat collective fabric this costs O(N · |params|) on the busiest link
(gather at the server + re-broadcast) against ring allreduce's
O(2 · |params|) per link — the reason the paper (and Horovod) moved to
allreduce.  The pattern in collectives: ``all_gather`` of every worker's
gradient (server ingest), the update, then a ``broadcast`` of the
parameters from rank 0 (server egress); the groups' byte counters show
the contrast with ``hvd.make_train_step``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch import optim
from repro_torch.core import hvd
from repro_torch.distributed.stepfn import value_and_grad


def make_train_step(loss_fn: Callable, optimizer: optim.Optimizer,
                    groups: hvd.Groups) -> Callable:
    """Parameter-server-patterned ``step(params, opt_state, *args) ->
    (params, opt_state, metrics)`` over every axis of ``groups``."""
    world = groups.world

    def step(params, opt_state, *args):
        loss, metrics, grads = value_and_grad(
            lambda p, a: loss_fn(p, *a), params, args)
        # workers -> server: every worker's full gradient, averaged there
        # (each rank does the server's arithmetic on the gathered copy)
        gathered = hvd.allgather(grads, world)
        mean_grads = optim.tree_map(
            lambda g, a: a.view(world.size, *g.shape).mean(dim=0), grads,
            gathered)
        updates, opt_state = optimizer.update(mean_grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        # server -> workers: the refreshed parameters from rank 0
        params = hvd.broadcast(params, world, root=0)
        metrics = hvd.allreduce(dict(metrics, loss=loss), world)
        return params, opt_state, metrics

    return step
