"""The decoder stacks: dense (llama-style pre-norm GQA; qwen2 QKV bias;
gemma2 local/global windows, logit softcaps, post-block norms, scaled
embeddings) and ssm (mamba2, attention-free).

Counterpart of ``repro.models.transformer`` for ``family="dense"`` and
``family="ssm"``.  The parameter tree keeps the reference's layout —
dense per-layer leaves stacked as ``(L // pat, pat, ...)`` where
``pat = len(layer_pattern(cfg))``, ssm leaves as ``(L, ...)`` — so
``repro_torch.bridge`` moves weights between the packages leaf for leaf.
PyTorch runs eagerly: the reference's ``lax.scan`` over layer groups is a
Python loop (each group, or each mamba layer, under
``torch.utils.checkpoint`` when ``cfg.remat``), and the decode caches
are updated in place.

Ported: the full-sequence ``forward`` and the losses of training
(``lm_loss``, ``lm_loss_chunked``) for both families, and for dense
decoders the serving steps: ``decode_step`` over a dense per-slot cache
(``init_cache``: bf16, or int8 codes with per-token scales) or paged KV,
and ``prefill_step`` over paged KV.  The other families, and ssm
decoding, come with the slices that need them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
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


def _check_family(cfg, families=("dense",)) -> None:
    """Raise for a family this entry point does not run yet: the training
    path runs ``("dense", "ssm")``, the serving steps dense decoders."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is ported with a later slice; here the "
            f"port runs {', '.join(families)}")


_TRAIN_FAMILIES = ("dense", "ssm")


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
    config's compute dtype), norm scales and the leaves the reference uses
    in f32 (``ssm.F32_LEAVES``) in f32."""
    _check_family(cfg, _TRAIN_FAMILIES)
    wdt = weight_dtype or _dtype(cfg.dtype)
    if cfg.family == "ssm":
        return _init_ssm_params(cfg, generator, device, wdt)
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


def _init_ssm_params(cfg, generator, device, wdt):
    """The ssm family's tree: tied embedding, final norm, and per-layer
    ``{"ln1", "mamba"}`` leaves stacked as ``(L, ...)``."""
    L, d = cfg.num_layers, cfg.d_model
    table = nn.truncated_normal_(
        torch.empty((cfg.vocab_size, d), dtype=torch.float32), 0.02,
        generator).to(device, wdt)
    p: Dict[str, Any] = {
        "embed": {"table": table},
        "final_norm": {"scale": torch.zeros((d,), dtype=torch.float32,
                                            device=device)},
        "layers": {
            "ln1": {"scale": torch.zeros((L, d), dtype=torch.float32,
                                         device=device)},
            "mamba": ssm_lib.init_mamba2(cfg, generator, lead=(L,),
                                         device=device, weight_dtype=wdt),
        },
    }
    return p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _cache_struct(cfg, batch: int, seq_len: int):
    """Nested dict of (shape, dtype) describing the dense-family decode
    cache: ``(L // pat, pat, batch, seq_len, KV, D)`` per k/v leaf, bf16;
    with ``cfg.kv_cache_dtype == "int8"`` the k/v leaves are int8 codes
    and ``k_scale`` / ``v_scale`` ``(L // pat, pat, batch, seq_len, KV)``
    bf16 hold one absmax scale per (token, kv head)."""
    _check_family(cfg)
    pat = len(layer_pattern(cfg))
    lead = (cfg.num_layers // pat, pat, batch, seq_len, cfg.num_kv_heads)
    shape = lead + (cfg.resolved_head_dim,)
    if cfg.kv_cache_dtype == "int8":
        return {"layers": {"k": (shape, torch.int8),
                           "v": (shape, torch.int8),
                           "k_scale": (lead, torch.bfloat16),
                           "v_scale": (lead, torch.bfloat16)}}
    return {"layers": {"k": (shape, torch.bfloat16),
                       "v": (shape, torch.bfloat16)}}


def init_cache(cfg, batch: int, seq_len: int, device="cpu"):
    """Zeros of ``_cache_struct``: the dense per-slot decode cache."""
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


def _apply_mamba_layer(p, cfg, x):
    """Pre-norm mamba2 block (no cache) plus the residual.  The residual
    enters rounded to the compute dtype (each layer is a scan step of its
    own in the reference), so there is no ``x_sum`` here."""
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    return x + ssm_lib.mamba2_block(p["mamba"], cfg, h)[0]


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


def forward(params, cfg, batch: Dict[str, Any], *, last_only: bool = False,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward (training, prefill).  batch: tokens
    (B, S).  Returns (logits (B, S, V) f32, aux_loss 0-d f32 (zero for
    dense and ssm decoders)).

    last_only: unembed only the final position.  return_hidden: return the
    final-norm hidden states (B, S, d) in the compute dtype instead of
    logits (the chunked loss unembeds them itself).  With ``cfg.remat``
    each layer group (dense) or layer (ssm) runs under
    ``torch.utils.checkpoint`` (the reference's rematted scan body): its
    activations are recomputed in the backward, so attention or the SSD
    scan runs twice per layer per training step."""
    _check_family(cfg, _TRAIN_FAMILIES)
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "ssm":
        body, steps = _apply_mamba_layer, cfg.num_layers
    else:
        body, steps = _forward_group, cfg.num_layers // len(
            layer_pattern(cfg))
    for gi in range(steps):
        gp = _index(params["layers"], gi)
        if cfg.remat:
            x = checkpoint(body, gp, cfg, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(gp, cfg, x)
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
    cache is the dense per-slot tree of ``init_cache`` (row b's token
    written at ``positions[b]``); with them it is paged block storage.
    Either is updated in place.  Returns (logits (B, 1, V) f32, cache)."""
    _check_family(cfg)
    tokens, idx, cache = batch["tokens"], batch["positions"], batch["cache"]
    x = _embed(params, cfg, tokens)
    x = _run_layers(params, cfg, x, cache, positions=idx[:, None],
                    cache_index=idx, block_tables=batch.get("block_tables"))
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
