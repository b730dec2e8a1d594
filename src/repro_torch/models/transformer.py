"""The dense decoder stack (llama-style pre-norm GQA; qwen2 QKV bias; gemma2
local/global windows, logit softcaps, post-block norms, scaled embeddings).

Counterpart of ``repro.models.transformer`` for ``family="dense"``.  The
parameter tree keeps the reference's layout — per-layer leaves stacked as
``(L // pat, pat, ...)`` where ``pat = len(layer_pattern(cfg))`` — so
``repro_torch.bridge`` moves weights between the packages leaf for leaf.
PyTorch runs eagerly: the reference's ``lax.scan`` over layer groups is a
Python loop, and the paged KV storage is updated in place.

This slice ports the serving steps over paged KV (``decode_step``,
``prefill_step``); ``forward``, the losses and the other families come
with the slices that need them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn


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


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is ported with a later slice; this "
            "slice serves dense decoders")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cpu",
                weight_dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random weights with the reference's truncated-normal stddevs
    (``transformer.init_params``).  The numbers are the port's own — a
    ``torch.Generator`` cannot reproduce ``jax.random`` — so parity tests
    bridge the reference's weights instead.  Draws happen on the CPU from
    ``generator`` (same weights whatever ``device``); linear, bias and
    embedding leaves are then held in ``weight_dtype`` (default: the
    config's compute dtype), norm scales in f32."""
    _check_family(cfg)
    wdt = weight_dtype or _dtype(cfg.dtype)
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh, dff, L = cfg.resolved_head_dim, cfg.d_ff, cfg.num_layers
    pat = len(layer_pattern(cfg))
    assert L % pat == 0, (L, pat)
    lead = (L // pat, pat)

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        return nn.truncated_normal_(t, std, generator).to(device, wdt)

    def zeros(shape, dtype=wdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin(d_in, out, std=None, bias=False):
        out = (out,) if isinstance(out, int) else tuple(out)
        p = {"w": normal(lead + (d_in, *out), std or 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = zeros(lead + out)
        return p

    def norm():
        return {"scale": zeros(lead + (d,), torch.float32)}

    layer = {
        "ln1": norm(), "ln2": norm(),
        "attn": {
            "wq": lin(d, (h, dh), bias=cfg.qkv_bias),
            "wk": lin(d, (kvh, dh), bias=cfg.qkv_bias),
            "wv": lin(d, (kvh, dh), bias=cfg.qkv_bias),
            "wo": lin(h * dh, d, std=1.0 / math.sqrt(h * dh)),
        },
        "mlp": {"wi": lin(d, dff), "wg": lin(d, dff), "wo": lin(dff, d)},
    }
    if cfg.post_block_norm:
        layer["post_ln1"] = norm()
        layer["post_ln2"] = norm()
    p: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, d), 0.02)},
        "final_norm": {"scale": torch.zeros((d,), dtype=torch.float32,
                                            device=device)},
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))}
    return p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _cache_struct(cfg, batch: int, seq_len: int):
    """Nested dict of (shape, dtype) describing the dense-family decode
    cache: ``(L // pat, pat, batch, seq_len, KV, D)`` bf16 per leaf."""
    _check_family(cfg)
    pat = len(layer_pattern(cfg))
    shape = (cfg.num_layers // pat, pat, batch, seq_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {"k": (shape, torch.bfloat16),
                       "v": (shape, torch.bfloat16)}}


def _index(tree, gi: int, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, gi, i) for k, v in tree.items()}
    return tree[gi, i]


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg, x, x_sum, *, window, positions, cache,
                 cache_index, block_tables, q_lens=None):
    """Pre-norm attention + MLP (+ gemma2 post-block norms).

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
    m = nn.mlp(p["mlp"], hn, cfg.act, dtype=dt)
    if cfg.post_block_norm:
        m = nn.rmsnorm(p["post_ln2"], m, cfg.norm_eps, out_dtype=dt)
    return add(x, m)


def _embed(params, cfg, tokens):
    dt = _dtype(cfg.dtype)
    x = nn.embed(params["embed"], tokens, dtype=dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                             device=x.device)
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


def _logits(params, cfg, x):
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = nn.unembed(params["embed"], x)
    else:
        logits = nn.linear(params["lm_head"], x,
                           dtype=_dtype(cfg.dtype)).float()
    return nn.softcap(logits, cfg.final_logit_softcap)


def _require_paged(batch, what: str):
    if batch.get("block_tables") is None:
        raise NotImplementedError(
            f"{what} over a dense per-slot cache is ported with the "
            "dense-mode serving slice; pass block_tables (paged KV)")


# ---------------------------------------------------------------------------
# Decode step (one token per row against paged KV)
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, cfg, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Any]:
    """One-token decode.  batch: tokens (B, 1), positions (B,), cache
    (paged block storage, updated in place), block_tables
    (B, blocks_per_slot).  Returns (logits (B, 1, V) f32, cache)."""
    _check_family(cfg)
    _require_paged(batch, "decode_step")
    tokens, idx, cache = batch["tokens"], batch["positions"], batch["cache"]
    x = _embed(params, cfg, tokens)
    x = _run_layers(params, cfg, x, cache, positions=idx[:, None],
                    cache_index=idx, block_tables=batch["block_tables"])
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
    garbage — callers index only real tokens."""
    _check_family(cfg)
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
