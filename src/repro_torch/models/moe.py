"""Mixture-of-Experts: a top-k router and the capacity-bounded, sort-based
dispatch of ``repro.models.moe``, as plain functions on tensors.

Tokens are taken in ``G`` contiguous groups of ``Tg`` (the group size
divides the token count and is the largest not above
``cfg.moe_group_size``: a decode batch is one group).  In each group the
router's top ``K`` experts of every token are sorted by expert id
(stably), each (token, k) slot gets its rank inside its expert's segment,
and the first ``C`` (``expert_capacity``) slots of an expert are
scattered into a dense ``(G, E, C, d)`` buffer; the rest are dropped
(zero weight, parked at ``(0, C - 1)``).  Every expert's gated MLP runs
over all of its ``C`` rows, filled or not, as one batched product over
the expert axis, and each token sums its ``K`` slots' outputs weighted by
its renormalised router probabilities.

The numbers follow the reference's rounding points: the router is an
f32 product on the norm's bf16 output widened to f32; its top ``K`` are
taken from a stable descending sort, so equal probabilities go to the
lower expert id first, as ``lax.top_k`` does (a zero router picks
experts ``0 .. K-1``); the expert products are in the compute dtype
with f32 accumulation, through ``modules.activation`` with the same
rounding of ``a(hg) * hi`` as ``modules.mlp``; the combine sums the ``K``
slots in f32 and rounds once to ``x``'s dtype.

Everything is shape-static and free of host syncs (no ``nonzero``, no
boolean indexing, no ``.item()``): the group size and the capacity come
from Python ints, so a whole block runs inside a captured serving round
(``serving/programs.py``).

Training differentiates through all of it: the ``index_add_`` of the
dispatch and the gather of the slots carry gradients to the tokens, the
gate weights carry them to the router, and the aux loss is returned for
the loss to add.  Expert parallelism (``modules.Shards`` splitting the
experts over ``model``): the router, the capacity, the dispatch and the
aux loss stay replicated and exact on every rank (the aux loss's router
means are taken over the whole global batch, ``Shards.batch_mean``, as
the reference's are; the dispatch groups are each rank's rows, the
reference's too where its group size divides a rank's tokens, as it does
at the full configs' shapes); each rank runs the
gated MLP of its E / m experts over their slots of the ``(G, E, C, d)``
buffer, sums the weighted outputs of the slots its experts hold into
``(B, S, d)`` in f32, and the ranks' sums are all_reduced, then rounded
once to x's dtype.  That is one all_reduce of B S d f32 values a layer
instead of one of the buffer.  Against the reference's single f32 sum
over a token's K slots it adds in another order (each rank's slots, then
the ranks), so the f32 sum may differ in its last bits, and the bf16
output by one ulp where that moves a rounding; at m = 1 it is the same
sum.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models import modules as nn

# path suffixes of the leaves the reference computes in f32 (the router
# is an f32 product of f32 parameters): held in f32 whatever the weight
# dtype
F32_SUFFIXES = (("router", "w"),)

# the profiler range around everything of ``moe_block`` but the expert
# products (the router, the aux loss, the dispatch into the capacity
# buffer, the gather and combine of the slots): a profile reads the
# dispatch's device time from the ops under it
DISPATCH_RANGE = "moe_dispatch"


def expert_capacity(tokens_per_group: int, cfg) -> int:
    """Slots per expert and group: ``ceil(Tg K cf / E)`` padded up to a
    multiple of 8, at least 8 (the reference's numbers, in Python
    floats as numpy's)."""
    c = int(math.ceil(tokens_per_group * cfg.num_experts_per_tok
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def group_size(tokens: int, cfg) -> int:
    """The largest divisor of ``tokens`` not above ``cfg.moe_group_size``."""
    tpg = min(cfg.moe_group_size, tokens)
    while tokens % tpg:
        tpg -= 1
    return tpg


def _dispatch_indices(eidx: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group dispatch bookkeeping.  ``eidx``: ``(..., T, K)`` expert
    ids, one group per leading index.  Returns ``(expert, rank, keep)``,
    each ``(..., T * K)``: a slot's expert (0 where dropped), its rank in
    its expert's segment (``capacity - 1`` where dropped), and whether
    the rank is below ``capacity``."""
    *lead, T, K = eidx.shape
    flat = eidx.reshape(*lead, T * K).long()
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    pos = torch.arange(T * K, device=flat.device).expand_as(flat)
    is_start = torch.ones_like(flat, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    # undo the sort: the inverse permutation scatters, it does not re-sort
    rank = torch.empty_like(flat).scatter_(-1, order, pos - seg_start)
    keep = rank < capacity
    return (torch.where(keep, flat, 0), torch.where(keep, rank, capacity - 1),
            keep)


def route(params, cfg, xg: torch.Tensor):
    """The router on ``xg`` ``(G, Tg, d)``: f32 logits, softmax, the top
    ``K`` by a stable descending sort.  Returns ``(probs (G, Tg, E),
    gate (G, Tg, K) renormalised, eidx (G, Tg, K))``."""
    logits = nn.linear(params["router"], xg.float(), dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    gate, eidx = vals[..., :K], idx[..., :K]
    return probs, gate / gate.sum(dim=-1, keepdim=True), eidx


def moe_block(params, cfg, x: torch.Tensor, shards=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, S, d)`` -> ``(out (B, S, d) in x's dtype, aux)``, aux the
    Switch-style load-balance loss (0-d f32).  ``shards``: expert
    parallelism over ``model`` (the module's docstring)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    dt = getattr(torch, cfg.dtype)
    Tg = group_size(T, cfg)
    G = T // Tg
    C = expert_capacity(Tg, cfg)
    xg = x.reshape(G, Tg, d)
    ep = shards is not None and shards.dim("wi") is not None

    with torch.profiler.record_function(DISPATCH_RANGE):
        probs, gate, eidx = route(params, cfg, xg)

        # aux: mean router probability times the share of tokens whose
        # first choice is each expert (a count: no one_hot, no host sync)
        first = torch.zeros(E, dtype=torch.float32, device=x.device)
        first.index_add_(0, eidx[..., 0].reshape(-1),
                         torch.ones(T, dtype=torch.float32, device=x.device))
        me, ce = probs.mean(dim=(0, 1)), first / T
        if shards is not None:          # over the whole global batch
            me, ce = shards.batch_mean(me), shards.batch_mean(ce)
        aux = (cfg.router_aux_loss_coef * E) * torch.sum(me * ce)

        safe_e, safe_r, keep = _dispatch_indices(eidx, C)      # (G, Tg K)
        # row of each slot in the flat (G E C, d) buffer; kept (e, r)
        # pairs are unique and dropped slots add zeros, so the buffer does
        # not depend on the order of the additions
        grp = torch.arange(G, device=x.device)[:, None]
        row = (grp * E + safe_e) * C + safe_r
        tok = torch.arange(Tg * K, device=x.device) // K
        contrib = torch.where(keep[..., None], xg[:, tok].to(dt), 0)
        buf = torch.zeros((G * E * C, d), dtype=dt, device=x.device)
        buf = buf.index_add(0, row.reshape(-1), contrib.reshape(-1, d))
        buf = buf.view(G, E, C, d)
        w = torch.where(keep, gate.reshape(G, Tg * K), 0.0)
        if ep:
            # this rank's experts [lo, lo + El): their slots of the buffer,
            # the slots they hold; the gate weights enter the sharded
            # region (their gradient is the ranks' sum)
            El = params["wi"].shape[-3]
            lo = shards.model.rank * El
            buf = shards.split(buf, 1)
            mine = keep & (safe_e >= lo) & (safe_e < lo + El)
            row = (grp * El + (safe_e - lo).clamp(0, El - 1)) * C + safe_r
            w = torch.where(mine, shards.copy_in(w), 0.0)
        else:
            El = E

    a = nn.activation(cfg.act)
    hg = torch.einsum("gecd,edf->gecf", buf, params["wg"].to(dt))
    hi = torch.einsum("gecd,edf->gecf", buf, params["wi"].to(dt))
    ho = torch.einsum("gecf,efd->gecd", a(hg) * hi, params["wo"].to(dt))

    with torch.profiler.record_function(DISPATCH_RANGE):
        slot_out = ho.reshape(G * El * C, d)[row]               # (G, Tg K, d)
        out = (slot_out.float() * w[..., None]).reshape(G, Tg, K, d).sum(
            dim=2)
        if ep:
            out = shards.reduce_out(out)
    return out.reshape(B, S, d).to(x.dtype), aux


def init_moe(cfg, draw, lead=()) -> Dict[str, torch.Tensor]:
    """One MoE block's leaves, stacked with leading dims ``lead``: the f32
    router ``(d, E)`` and the expert-stacked gated MLP ``wi``, ``wg``
    ``(E, d, d_ff)`` and ``wo`` ``(E, d_ff, d)``.  ``draw(shape, std,
    f32)`` makes one truncated-normal leaf (``modules.drawer``)."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)
    return {
        "router": {"w": draw(lead + (d, e), s, True)},
        "wi": draw(lead + (e, d, dff), s, False),
        "wg": draw(lead + (e, d, dff), s, False),
        "wo": draw(lead + (e, dff, d), 1.0 / math.sqrt(dff), False),
    }
