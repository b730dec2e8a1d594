"""The decoder stacks: dense (llama-style pre-norm GQA; qwen2 QKV bias;
gemma2 local/global windows, logit softcaps, post-block norms, scaled
embeddings), moe (the dense stack with the top-k MoE block of
``models/moe.py`` in place of the MLP: qwen3-moe, dbrx), ssm (mamba2,
attention-free) and hybrid (zamba2: mamba2 layers with one weight-shared
attention + MLP block applied after every ``hybrid_attn_every`` of them).

Counterpart of ``repro.models.transformer`` for ``family`` in ``dense``,
``moe``, ``ssm`` and ``hybrid``.  The parameter tree keeps the reference's
layout — dense and moe per-layer leaves stacked as ``(L // pat, pat,
...)`` (a moe layer's ``moe/wi`` is ``(L, 1, E, d, d_ff)``) where
``pat = len(layer_pattern(cfg))``, ssm leaves as ``(L, ...)``, hybrid
mamba leaves as ``(G, E, ...)`` (``E = hybrid_attn_every``, ``G = L //
E``) with the ``L % E`` tail layers as ``(R, ...)`` and the unstacked
``shared_attn`` layer — so ``repro_torch.bridge`` moves weights between
the packages leaf for leaf.  PyTorch runs eagerly: the reference's
``lax.scan`` over layer groups is a Python loop (each dense group, each
mamba layer and each application of the shared block under
``torch.utils.checkpoint`` when ``cfg.remat``), and the decode caches
are updated in place.

Ported: the full-sequence ``forward`` and the losses of training
(``lm_loss``, ``lm_loss_chunked``) for the dense, ssm and hybrid
families (the moe family's training waits for sharded training, ROADMAP
Queue 1 item 6); ``decode_step`` for all four over a dense per-slot cache
(``init_cache``: attention K/V in bf16, or int8 codes with per-token
scales; the mamba layers' f32 SSM and conv state), and for dense and moe
decoders over paged KV; ``prefill_step`` over paged KV for dense and moe
decoders (the ssm and hybrid families have no positional cache, and the
reference refuses them there too).  The other families come with the
slices that need them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Layer pattern: windows per position in the layer group
# ---------------------------------------------------------------------------

def layer_pattern(cfg):
    """Window sizes (None = full attention), one per layer of a group.
    gemma2 alternates (local, global).  (The reference's ``long_context``
    variant, for its 500k-token dry-run shapes, has no caller here.)"""
    if cfg.local_global_pattern:
        return (cfg.sliding_window, None)
    return (cfg.sliding_window,)


def _check_family(cfg, families) -> None:
    """Raise for a family this entry point does not run yet: serving
    (``init_params``, ``init_cache``, ``decode_step``) runs ``_FAMILIES``,
    paged prefill the families with a positional cache."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is ported with a later slice; here the "
            f"port runs {', '.join(families)}")


def check_trainable(cfg) -> None:
    """Raise for a family ``forward`` and the losses do not train: the
    moe family waits for sharded training (its AdamW state fits no single
    card), the unported families for their slices."""
    if cfg.family == "moe":
        raise NotImplementedError(
            "training the moe family waits for sharded training (ROADMAP "
            "Queue 1 item 6): its AdamW state fits no single card; the port "
            "serves it")
    _check_family(cfg, _FAMILIES)


_FAMILIES = ("dense", "moe", "ssm", "hybrid")
_POSITIONAL = ("dense", "moe")       # attention caches with a token axis


def _refuse_paged(cfg) -> None:
    """The reference's refusal of paged block storage for a family whose
    cache holds recurrent state (no token-position axis)."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"paged prefill needs a positional attention cache; family "
            f"{cfg.family!r} unsupported")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cpu",
                weight_dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random weights with the reference's truncated-normal stddevs
    (``transformer.init_params``).  The numbers are the port's own — a
    ``torch.Generator`` cannot reproduce ``jax.random`` — so parity tests
    bridge the reference's weights instead.  Linear, bias and embedding
    leaves are held in ``weight_dtype`` (default: the config's compute
    dtype), norm scales and the leaves the reference uses in f32
    (``ssm.F32_LEAVES``, the MoE router) in f32.

    Every leaf is drawn on the generator's device (``modules.drawer``):
    the weights depend on the generator and its seed, not on ``device``.
    From ``torch.Generator(device="cuda")`` a full-width qwen3-moe is made
    on the card in seconds, one layer slice in f32 at a time."""
    _check_family(cfg, _FAMILIES)
    wdt = weight_dtype or _dtype(cfg.dtype)
    if cfg.family in ("ssm", "hybrid"):
        return _init_mamba_params(cfg, generator, device, wdt)
    draw = nn.drawer(generator, device, wdt)
    L = cfg.num_layers
    pat = len(layer_pattern(cfg))
    assert L % pat == 0, (L, pat)
    layers = _init_attn_mlp_layer(cfg, draw, (L // pat, pat), device, wdt)
    p: Dict[str, Any] = {
        "embed": {"table": draw((cfg.vocab_size, cfg.d_model), 0.02)},
        "final_norm": {"scale": _zeros((cfg.d_model,), device)},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        d = cfg.d_model
        p["lm_head"] = {"w": draw((d, cfg.vocab_size), 1.0 / math.sqrt(d))}
    return p


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


def _init_attn_mlp_layer(cfg, draw, lead, device, wdt):
    """One pre-norm attention + gated-MLP (or MoE) layer's leaves, stacked
    with leading dims ``lead`` (``()`` for the hybrid family's shared
    block); ``draw`` from ``modules.drawer``."""
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh, dff = cfg.resolved_head_dim, cfg.d_ff
    lead = tuple(lead)

    def lin(d_in, out, std=None, bias=False):
        out = (out,) if isinstance(out, int) else tuple(out)
        p = {"w": draw(lead + (d_in, *out), std or 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = _zeros(lead + out, device, wdt)
        return p

    def norm():
        return {"scale": _zeros(lead + (d,), device)}

    layer = {
        "ln1": norm(), "ln2": norm(),
        "attn": {
            "wq": lin(d, (h, dh), bias=cfg.qkv_bias),
            "wk": lin(d, (kvh, dh), bias=cfg.qkv_bias),
            "wv": lin(d, (kvh, dh), bias=cfg.qkv_bias),
            "wo": lin(h * dh, d, std=1.0 / math.sqrt(h * dh)),
        },
    }
    if cfg.family == "moe":
        layer["moe"] = moe_lib.init_moe(cfg, draw, lead)
    else:
        layer["mlp"] = {"wi": lin(d, dff), "wg": lin(d, dff),
                        "wo": lin(dff, d)}
    if cfg.post_block_norm:
        layer["post_ln1"] = norm()
        layer["post_ln2"] = norm()
    return layer


def _init_mamba_layers(cfg, generator, lead, device, wdt):
    """``{"ln1", "mamba"}`` leaves stacked with leading dims ``lead``."""
    return {"ln1": {"scale": _zeros(tuple(lead) + (cfg.d_model,), device)},
            "mamba": ssm_lib.init_mamba2(cfg, generator, lead=lead,
                                         device=device, weight_dtype=wdt)}


def _hybrid_groups(cfg) -> Tuple[int, int, int]:
    """(E, G, R): mamba layers a group, groups, tail layers."""
    E = cfg.hybrid_attn_every
    return E, cfg.num_layers // E, cfg.num_layers % E


def _init_mamba_params(cfg, generator, device, wdt):
    """The ssm and hybrid trees: tied embedding, final norm, and mamba
    layers stacked as ``(L, ...)`` (ssm) or ``(G, E, ...)`` plus
    ``tail_layers`` ``(R, ...)`` and one unstacked ``shared_attn`` layer
    (hybrid)."""
    p: Dict[str, Any] = {
        "embed": {"table": nn.drawer(generator, device, wdt)(
            (cfg.vocab_size, cfg.d_model), 0.02)},
        "final_norm": {"scale": _zeros((cfg.d_model,), device)},
    }
    if cfg.family == "ssm":
        p["layers"] = _init_mamba_layers(cfg, generator, (cfg.num_layers,),
                                         device, wdt)
        return p
    E, G, R = _hybrid_groups(cfg)
    p["layers"] = _init_mamba_layers(cfg, generator, (G, E), device, wdt)
    if R:
        p["tail_layers"] = _init_mamba_layers(cfg, generator, (R,), device,
                                              wdt)
    p["shared_attn"] = _init_attn_mlp_layer(
        cfg, nn.drawer(generator, device, wdt), (), device, wdt)
    return p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _cache_struct(cfg, batch: int, seq_len: int):
    """Nested dict of (shape, dtype) describing the decode cache.

    Attention K/V: ``(lead, batch, seq_len, KV, D)`` per k/v leaf, bf16;
    with ``cfg.kv_cache_dtype == "int8"`` the k/v leaves are int8 codes
    and ``k_scale`` / ``v_scale`` ``(lead, batch, seq_len, KV)`` bf16 hold
    one absmax scale per (token, kv head).  Mamba state: ``ssm`` ``(lead,
    batch, H, N, P)`` and ``conv`` ``(lead, batch, w - 1, d_inner + 2 G
    N)``, f32, with no sequence axis.  ``lead`` is ``(L // pat, pat)``
    (dense), ``(L,)`` (ssm), or for the hybrid family ``(G, E)`` for the
    mamba groups, ``(R,)`` for ``tail_layers`` and ``(G,)`` for
    ``shared_attn``, one K/V stripe per application of the shared block."""
    _check_family(cfg, _FAMILIES)
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim if cfg.num_heads else 0

    def attn_cache(lead):
        shape = lead + (batch, seq_len, kv, dh)
        if cfg.kv_cache_dtype == "int8":
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": (shape[:-1], torch.bfloat16),
                    "v_scale": (shape[:-1], torch.bfloat16)}
        return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}

    def mamba_cache(lead):
        H, N, P = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_head_dim
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {"ssm": (lead + (batch, H, N, P), torch.float32),
                "conv": (lead + (batch, cfg.ssm_conv_width - 1, conv_dim),
                         torch.float32)}

    if cfg.family in _POSITIONAL:
        pat = len(layer_pattern(cfg))
        return {"layers": attn_cache((cfg.num_layers // pat, pat))}
    if cfg.family == "ssm":
        return {"layers": mamba_cache((cfg.num_layers,))}
    E, G, R = _hybrid_groups(cfg)
    c = {"layers": mamba_cache((G, E)), "shared_attn": attn_cache((G,))}
    if R:
        c["tail_layers"] = mamba_cache((R,))
    return c


def init_cache(cfg, batch: int, seq_len: int, device="cpu"):
    """Zeros of ``_cache_struct``: the per-slot decode cache."""
    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        shape, dtype = node
        return torch.zeros(shape, dtype=dtype, device=device)
    return zeros(_cache_struct(cfg, batch, seq_len))


def _index(tree, *idx):
    """Every leaf of a stacked tree indexed by ``idx`` (a layer group, or
    a group and a layer in it)."""
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg, x, x_sum, *, window, positions, cache,
                 cache_index, block_tables, q_lens=None):
    """Pre-norm attention + MLP, or the MoE block where ``p`` has
    ``"moe"`` (its aux loss is dropped: serving only) (+ gemma2
    post-block norms).

    ``x`` is the residual stream in the compute dtype; ``x_sum`` is the
    same value in f32 *before* its last rounding, or None.  The port keeps
    the precision the reference's compiled layer group has: XLA folds the
    bf16 rounding of an add into a following f32 convert, so a norm reads
    the residual add unrounded.  Each residual add returns both the
    rounded sum, which carries on, and the unrounded one, which the next
    norm reads.  Returns ``(x, x_sum)``."""
    dt = _dtype(cfg.dtype)

    def add(a, b):
        s = a.float() + b.float()
        return s.to(dt), s

    hn = nn.rmsnorm(p["ln1"], x if x_sum is None else x_sum, cfg.norm_eps,
                    out_dtype=dt)
    a, _ = attn.attention_block(
        p["attn"], cfg, hn, positions=positions, window=window, cache=cache,
        cache_index=cache_index, block_tables=block_tables, q_lens=q_lens)
    if cfg.post_block_norm:
        a = nn.rmsnorm(p["post_ln1"], a, cfg.norm_eps, out_dtype=dt)
    x, x_sum = add(x, a)
    hn = nn.rmsnorm(p["ln2"], x_sum, cfg.norm_eps, out_dtype=dt)
    if "moe" in p:
        m, _ = moe_lib.moe_block(p["moe"], cfg, hn)
    else:
        m = nn.mlp(p["mlp"], hn, cfg.act, dtype=dt)
    if cfg.post_block_norm:
        m = nn.rmsnorm(p["post_ln2"], m, cfg.norm_eps, out_dtype=dt)
    return add(x, m)


def _apply_mamba_layer(p, cfg, x, x_sum=None, cache=None):
    """Pre-norm mamba2 block plus the residual, with ``_apply_layer``'s
    ``(x, x_sum)`` convention: the norm reads ``x_sum`` (the residual
    before its last rounding) when given.  ``cache``: this layer's
    ``{"ssm", "conv"}`` decode state, updated in place (the engine's
    programs read it at its address).  Returns ``(x, x_sum)``."""
    dt = _dtype(cfg.dtype)
    h = nn.rmsnorm(p["ln1"], x if x_sum is None else x_sum, cfg.norm_eps,
                   out_dtype=dt)
    m, new_cache = ssm_lib.mamba2_block(p["mamba"], cfg, h, cache=cache)
    if cache is not None:
        for name, t in new_cache.items():
            cache[name].copy_(t)
    s = x.float() + m.float()
    return s.to(dt), s


def _embed(params, cfg, tokens):
    dt = _dtype(cfg.dtype)
    x = nn.embed(params["embed"], tokens, dtype=dt)
    if cfg.embed_scale:
        x = x * nn.const(math.sqrt(cfg.d_model), x)
    return x


def _run_layers(params, cfg, x, cache, *, positions, cache_index,
                block_tables, q_lens=None):
    windows = layer_pattern(cfg)
    groups = cfg.num_layers // len(windows)
    layers, lcache = params["layers"], cache["layers"]
    for gi in range(groups):
        x_sum = None             # a group boundary rounds the stream
        for i, win in enumerate(windows):
            x, x_sum = _apply_layer(
                _index(layers, gi, i), cfg, x, x_sum, window=win,
                positions=positions, cache=_index(lcache, gi, i),
                cache_index=cache_index, block_tables=block_tables,
                q_lens=q_lens)
    return x


def _unembed(params, cfg, x):
    """Final-norm hidden states -> f32 logits (final softcap applied)."""
    if cfg.tie_embeddings:
        logits = nn.unembed(params["embed"], x)
    else:
        logits = nn.linear(params["lm_head"], x,
                           dtype=_dtype(cfg.dtype)).float()
    return nn.softcap(logits, cfg.final_logit_softcap)


def _logits(params, cfg, x):
    return _unembed(params, cfg,
                    nn.rmsnorm(params["final_norm"], x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Forward (train / prefill): the whole sequence, no cache
# ---------------------------------------------------------------------------

def _forward_group(gp, cfg, x):
    """One layer group of the no-cache forward.  The residual enters the
    group rounded (the reference's scan carry) and the ``x_sum`` rule of
    ``_apply_layer`` holds inside it."""
    x_sum = None
    for i, win in enumerate(layer_pattern(cfg)):
        x, x_sum = _apply_layer(_index(gp, i), cfg, x, x_sum,
                                window=win, positions=None, cache=None,
                                cache_index=None, block_tables=None)
    return x


def _shared_block(p, cfg, x, x_sum):
    """The hybrid family's shared attention + MLP block, no cache (the
    reference applies it with ``window=None``)."""
    return _apply_layer(p, cfg, x, x_sum, window=None, positions=None,
                        cache=None, cache_index=None, block_tables=None)


def _hybrid_trunk(params, cfg, x, mamba, shared):
    """The hybrid stack: G groups of E mamba layers each followed by the
    shared block, then the tail layers.  A group is one scan step of the
    reference, compiled as one body, so ``_apply_layer``'s ``x_sum`` rule
    holds across its layers: each norm reads the residual add before its
    bf16 rounding, each add the rounded residual (against the jitted
    reference in bf16 this leaves 20% of the smoke config's final hidden
    values one ulp apart; rounding after every layer leaves 86%).  The
    residual enters each group and each tail layer rounded (scan
    carries).  ``mamba(p, x, x_sum, where)`` applies a mamba layer,
    ``where`` naming its cache leaves (``("layers", gi, i)`` or
    ``("tail_layers", li)``); ``shared(x, x_sum, gi)`` applies the shared
    block in group ``gi``; each returns ``(x, x_sum)``."""
    E, G, R = _hybrid_groups(cfg)
    for gi in range(G):
        x_sum = None
        for i in range(E):
            x, x_sum = mamba(_index(params["layers"], gi, i), x, x_sum,
                             ("layers", gi, i))
        x, _ = shared(x, x_sum, gi)
    for li in range(R):
        x, _ = mamba(_index(params["tail_layers"], li), x, None,
                     ("tail_layers", li))
    return x


def forward(params, cfg, batch: Dict[str, Any], *, last_only: bool = False,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward (training, prefill).  batch: tokens
    (B, S).  Returns (logits (B, S, V) f32, aux_loss 0-d f32 (zero for
    the three families here; the moe family is refused until sharded
    training, ROADMAP Queue 1 item 6)).

    last_only: unembed only the final position.  return_hidden: return the
    final-norm hidden states (B, S, d) in the compute dtype instead of
    logits (the chunked loss unembeds them itself).  With ``cfg.remat``
    each layer group (dense), each mamba layer and each application of
    the hybrid family's shared block runs under ``torch.utils.checkpoint``
    (the reference remats whole scan steps; a hybrid group of six mamba
    layers and the shared block would hold all of their activations at
    once in the backward): its activations are recomputed in the
    backward, so attention or the SSD scan runs twice per layer per
    training step."""
    check_trainable(cfg)
    x = _embed(params, cfg, batch["tokens"])

    def run(fn, p, *carry):
        if cfg.remat:
            return checkpoint(fn, p, cfg, *carry, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(p, cfg, *carry)

    if cfg.family == "hybrid":
        x = _hybrid_trunk(
            params, cfg, x,
            lambda p, x, x_sum, _: run(_apply_mamba_layer, p, x, x_sum),
            lambda x, x_sum, _: run(_shared_block, params["shared_attn"], x,
                                    x_sum))
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x, _ = run(_apply_mamba_layer, _index(params["layers"], li), x)
    else:
        for gi in range(cfg.num_layers // len(layer_pattern(cfg))):
            x = run(_forward_group, _index(params["layers"], gi), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if last_only:
        x = x[:, -1:]
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return _unembed(params, cfg, x), aux


def _trunk(params, cfg, batch):
    """``forward`` up to (excluding) the unembedding: (hidden, aux)."""
    return forward(params, cfg, batch, return_hidden=True)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_metrics(loss, aux):
    return loss + aux, {"ce_loss": loss, "aux_loss": aux,
                        "perplexity": torch.exp(loss)}


def lm_loss(params, cfg, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy (logits[t] predicts labels[t + 1]) over
    the full (B, S, V) f32 logits.  Returns (loss, metrics)."""
    logits, aux = forward(params, cfg, batch)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = batch["labels"][:, 1:].long()
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return _loss_metrics(nll.mean(), aux)


def lm_loss_chunked(params, cfg, batch: Dict[str, Any], *,
                    seq_chunk: int = 512
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The same loss without the (B, S, V) logits: the trunk runs once,
    then each chunk of ``seq_chunk`` positions unembeds, takes
    logsumexp - target logit, and is recomputed in the backward
    (checkpointed), so the loss holds O(B * seq_chunk * V) at a time."""
    x, aux = _trunk(params, cfg, batch)
    B, S, _ = x.shape
    x = x[:, :-1]
    tgt = batch["labels"][:, 1:].long()
    Sm = S - 1
    pad = (-Sm) % seq_chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad))
    valid = (torch.arange(Sm + pad, device=x.device) < Sm).float()

    def chunk_nll(xc, tc, vc):
        logits = _unembed(params, cfg, xc)
        lse = torch.logsumexp(logits, dim=-1)
        hit = torch.gather(logits, -1, tc[..., None])[..., 0]
        return torch.sum((lse - hit) * vc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, Sm + pad, seq_chunk):
        sl = slice(c0, c0 + seq_chunk)
        total = total + checkpoint(chunk_nll, x[:, sl], tgt[:, sl],
                                   valid[None, sl], use_reentrant=False,
                                   preserve_rng_state=False)
    return _loss_metrics(total / (B * Sm), aux)


def _require_paged(batch, what: str):
    if batch.get("block_tables") is None:
        raise ValueError(
            f"{what} runs over paged block storage only (as in the "
            "reference); pass block_tables")


# ---------------------------------------------------------------------------
# Decode step (one token per row against a dense or paged cache)
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, cfg, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Any]:
    """One-token decode.  batch: tokens (B, 1), positions (B,), cache,
    and optionally block_tables (B, blocks_per_slot).  Without tables the
    cache is the per-slot tree of ``init_cache`` (row b's token written
    at ``positions[b]``; a mamba layer's state advanced by one token);
    with them (dense decoders only) it is paged block storage.  Either
    is updated in place.  Returns (logits (B, 1, V) f32, cache).
    Dense and moe decoders take either cache; the ssm and hybrid families
    the per-slot one."""
    _check_family(cfg, _FAMILIES)
    tokens, idx, cache = batch["tokens"], batch["positions"], batch["cache"]
    block_tables = batch.get("block_tables")
    if block_tables is not None:
        _refuse_paged(cfg)
    x = _embed(params, cfg, tokens)
    if cfg.family in _POSITIONAL:
        x = _run_layers(params, cfg, x, cache, positions=idx[:, None],
                        cache_index=idx, block_tables=block_tables)
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x, _ = _apply_mamba_layer(_index(params["layers"], li), cfg, x,
                                      cache=_index(cache["layers"], li))
    else:
        x = _hybrid_trunk(
            params, cfg, x,
            lambda p, x, x_sum, where: _apply_mamba_layer(
                p, cfg, x, x_sum, cache=_index(cache[where[0]], *where[1:])),
            lambda x, x_sum, gi: _apply_layer(
                params["shared_attn"], cfg, x, x_sum, window=None,
                positions=idx[:, None],
                cache=_index(cache["shared_attn"], gi), cache_index=idx,
                block_tables=None))
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Paged chunked-prefill step (a (B, C) query tile against block storage)
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, cfg, batch: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Any]:
    """One chunk of batched paged prefill: ``C`` tokens for every row.

    batch: tokens (B, C); positions (B,) — each row's *start* position;
    q_lens (B,) — valid tokens per row (padding tokens and rows are masked
    and their K/V routed to the trash block); cache — paged block storage,
    updated in place; block_tables (B, blocks_per_slot).  Returns
    (logits (B, C, V) f32, cache); logits at padding positions are
    garbage — callers index only real tokens, but every row of the tile
    runs the MoE block and so counts against expert capacity, as in the
    reference.  Dense and moe decoders only: the ssm and hybrid families
    raise ``ValueError``, as in the reference."""
    _refuse_paged(cfg)
    _check_family(cfg, _POSITIONAL)
    _require_paged(batch, "prefill_step")
    tokens, starts, cache = batch["tokens"], batch["positions"], batch["cache"]
    B, C = tokens.shape
    positions = (starts.to(torch.long)[:, None]
                 + torch.arange(C, device=tokens.device)[None])
    x = _embed(params, cfg, tokens)
    x = _run_layers(params, cfg, x, cache, positions=positions,
                    cache_index=starts, block_tables=batch["block_tables"],
                    q_lens=batch["q_lens"])
    return _logits(params, cfg, x), cache
