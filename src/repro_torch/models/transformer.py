"""The model stacks: dense (llama-style pre-norm GQA; qwen2 QKV bias;
gemma2 local/global windows, logit softcaps, post-block norms, scaled
embeddings), moe (the dense stack with the top-k MoE block of
``models/moe.py`` in place of the MLP: qwen3-moe, dbrx), ssm (mamba2,
attention-free), hybrid (zamba2: mamba2 layers with one weight-shared
attention + MLP block applied after every ``hybrid_attn_every`` of them),
vlm (qwen2-vl: the dense stack with stub patch embeddings prepended to
the text and M-RoPE positions) and encdec (whisper: a bidirectional
encoder over stub frame embeddings and a causal decoder with
cross-attention, LayerNorm, GELU and learned position embeddings).

Counterpart of ``repro.models.transformer``.  The parameter tree keeps
the reference's layout — dense, vlm and moe per-layer leaves stacked as
``(L // pat, pat, ...)`` (a moe layer's ``moe/wi`` is ``(L, 1, E, d,
d_ff)``) where ``pat = len(layer_pattern(cfg))``, ssm leaves as ``(L,
...)``, hybrid mamba leaves as ``(G, E, ...)`` (``E =
hybrid_attn_every``, ``G = L // E``) with the ``L % E`` tail layers as
``(R, ...)`` and the unstacked ``shared_attn`` layer, encdec decoder
layers as ``(L, ...)`` beside the ``encoder`` subtree (its layers
``(encoder_layers, ...)``, ``final_norm``, ``pos_embed``) — so
``repro_torch.bridge`` moves weights between the packages leaf for leaf.
PyTorch runs eagerly: the reference's ``lax.scan`` over layer groups is a
Python loop (each dense group, each encoder or decoder layer, each mamba
layer and each application of the shared block under
``torch.utils.checkpoint`` when ``cfg.remat``), and the decode caches are
updated in place.

Ported: the full-sequence ``forward`` and the losses of training
(``lm_loss``, ``lm_loss_chunked``) for every family, the moe family's
aux loss summed over its layers into the loss; under ``dp_tp`` /
``fsdp_tp`` (``shards``: ``modules.Shards`` over the whole params tree)
``forward`` and ``lm_loss`` run tensor-parallel over ``model`` — the
embedding, the attention and MLP blocks, the MoE block's experts and the
unembedding with the cross-entropy sharded as ``models/modules.py``,
``attention.py`` and ``moe.py`` say, a mamba2 layer replicated — with
each layer group's params all-gathered over ``data`` inside its
checkpointed call under ``fsdp_tp``; ``decode_step`` for all six over a
dense per-slot cache (``init_cache``: attention K/V in bf16, or int8
codes with per-token scales; the mamba layers' f32 SSM and conv state),
and for the dense, moe and vlm decoders over paged KV; ``prefill_step`` over paged KV for those three (the ssm,
hybrid and encdec families have no cache that depends on token positions
alone, and the reference refuses them there too).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
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

def layer_pattern(cfg, long_context: bool = False):
    """Window sizes (None = full attention), one per layer of a group.
    gemma2 alternates (local, global).  ``long_context`` (the
    ``long_500k`` shape): the global layers take ``cfg.long_context_window``
    (gemma2's is None, so its pattern stays), and a model with no window
    of its own takes it on every layer."""
    if cfg.local_global_pattern:
        g_win = cfg.long_context_window if long_context else None
        return (cfg.sliding_window, g_win)
    win = cfg.sliding_window
    if long_context and cfg.long_context_window is not None:
        win = cfg.long_context_window if win is None else win
    return (win,)


def _shared_window(cfg, long_context: bool):
    """The hybrid family's shared block's window: full attention, or
    ``cfg.long_context_window`` under the long-context variant."""
    return cfg.long_context_window if long_context else None


def _check_family(cfg, families) -> None:
    """Raise for a family this entry point does not run yet: serving
    (``init_params``, ``init_cache``, ``decode_step``) runs ``_FAMILIES``,
    paged prefill the families with a positional cache."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is ported with a later slice; here the "
            f"port runs {', '.join(families)}")


def check_trainable(cfg) -> None:
    """Raise for a family ``forward`` and the losses do not train (every
    family of ``_FAMILIES`` trains)."""
    _check_family(cfg, _FAMILIES)


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
# caches whose K/V depend on the token positions alone (encdec's also on
# the frames), the families paged storage takes
_POSITIONAL = ("dense", "moe", "vlm")


def positional_cache(cfg) -> bool:
    """Whether ``cfg``'s decode cache holds K/V keyed by token positions
    alone: the one cache paged block storage and token-keyed prefix reuse
    take.  Not recurrent state (no token-position axis), nor decoder K/V
    that depend on the encoder's frames too."""
    return cfg.family in _POSITIONAL


def _refuse_paged(cfg) -> None:
    """The reference's refusal of paged block storage for a family whose
    cache is not positional."""
    if not positional_cache(cfg):
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
    L, d = cfg.num_layers, cfg.d_model
    p: Dict[str, Any] = {}
    if cfg.family == "encdec":
        p["encoder"] = {
            "layers": _init_attn_mlp_layer(cfg, draw, (cfg.encoder_layers,),
                                           device, wdt),
            "final_norm": _init_norm(cfg, (), device),
            "pos_embed": draw((cfg.encoder_seq, d), 0.02),
        }
        p["layers"] = _init_attn_mlp_layer(cfg, draw, (L,), device, wdt,
                                           cross=True)
    else:
        pat = len(layer_pattern(cfg))
        assert L % pat == 0, (L, pat)
        p["layers"] = _init_attn_mlp_layer(cfg, draw, (L // pat, pat),
                                           device, wdt)
    # drawn after the layers, the order the dense and moe weights of
    # every seed have always been drawn in
    p["embed"] = {"table": draw((cfg.vocab_size, d), 0.02)}
    p["final_norm"] = _init_norm(cfg, (), device)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": draw((d, cfg.vocab_size), 1.0 / math.sqrt(d))}
    if cfg.max_pos_embed:
        p["pos_embed"] = draw((cfg.max_pos_embed, d), 0.02)
    return p


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


def _init_norm(cfg, lead, device):
    """A norm's f32 leaves stacked with leading dims ``lead``: RMSNorm's
    ``scale`` (zeros: the gain is ``1 + scale``), or LayerNorm's ``scale``
    (ones) and ``bias`` (zeros)."""
    shape = tuple(lead) + (cfg.d_model,)
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, dtype=torch.float32,
                                    device=device),
                "bias": _zeros(shape, device)}
    return {"scale": _zeros(shape, device)}


def _norm(cfg, p, x, out_dtype=None):
    """The config's norm (the reference's ``_norm``): LayerNorm (whisper)
    or RMSNorm, in f32, the result in ``out_dtype`` (default x's)."""
    if cfg.norm_type == "layernorm":
        return nn.layernorm(p, x, cfg.norm_eps, out_dtype=out_dtype)
    return nn.rmsnorm(p, x, cfg.norm_eps, out_dtype=out_dtype)


def _init_attn_mlp_layer(cfg, draw, lead, device, wdt, cross=False):
    """One pre-norm attention + gated-MLP (or MoE) layer's leaves, stacked
    with leading dims ``lead`` (``()`` for the hybrid family's shared
    block); ``draw`` from ``modules.drawer``.  ``cross``: an encdec
    decoder layer, with ``ln_cross`` and ``cross_attn`` (whose q/k/v
    have no bias, as in the reference)."""
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
        return _init_norm(cfg, lead, device)

    def attention(bias):
        return {"wq": lin(d, (h, dh), bias=bias),
                "wk": lin(d, (kvh, dh), bias=bias),
                "wv": lin(d, (kvh, dh), bias=bias),
                "wo": lin(h * dh, d, std=1.0 / math.sqrt(h * dh))}

    layer = {"ln1": norm(), "ln2": norm(), "attn": attention(cfg.qkv_bias)}
    if cross:
        layer["ln_cross"] = norm()
        layer["cross_attn"] = attention(False)
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
    (dense, vlm, moe), ``(L,)`` (ssm; encdec's decoder self-attention),
    or for the hybrid family ``(G, E)`` for the
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
    if cfg.family == "encdec":
        return {"layers": attn_cache((cfg.num_layers,))}
    if cfg.family == "ssm":
        return {"layers": mamba_cache((cfg.num_layers,))}
    E, G, R = _hybrid_groups(cfg)
    c = {"layers": mamba_cache((G, E)), "shared_attn": attn_cache((G,))}
    if R:
        c["tail_layers"] = mamba_cache((R,))
    return c


def _cache_map(fn, node):
    if isinstance(node, dict):
        return {k: _cache_map(fn, v) for k, v in node.items()}
    return fn(*node)


def init_cache(cfg, batch: int, seq_len: int, device="cpu"):
    """Zeros of ``_cache_struct``: the per-slot decode cache."""
    return _cache_map(lambda shape, dtype: torch.zeros(
        shape, dtype=dtype, device=device), _cache_struct(cfg, batch,
                                                           seq_len))


def init_cache_specs(cfg, batch: int, seq_len: int):
    """``_cache_struct`` as ``meta`` tensors: shapes and dtypes, no memory
    (the reference's ``ShapeDtypeStruct`` tree)."""
    return _cache_map(lambda shape, dtype: torch.empty(
        shape, dtype=dtype, device="meta"), _cache_struct(cfg, batch,
                                                          seq_len))


def _index(tree, *idx):
    """Every leaf of a stacked tree indexed by ``idx`` (a layer group, or
    a group and a layer in it)."""
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _unstack(tree):
    """The slices of a stacked tree along its leading dim, as a list of
    trees: one ``unbind`` a leaf, whose backward stacks the slices'
    gradients once (indexing each slice instead gives each a gradient of
    the whole stack, zeros but its slice, summed: memory traffic that
    grows with the square of the depth)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------

def _apply_layer(p, cfg, x, x_sum, *, window, positions, cache,
                 cache_index, block_tables, q_lens=None, causal=True,
                 encoder_out=None, use_rope=True, shards=None,
                 cache_seq=None):
    """Pre-norm attention + MLP, or the MoE block where ``p`` has
    ``"moe"`` (+ gemma2 post-block norms).  With ``encoder_out`` (encdec
    decoder layers) a pre-norm cross-attention block over it sits between
    the two, with its own residual add.  ``causal=False``: the encoder's
    self-attention; ``use_rope=False``: learned positions (whisper).

    ``x`` is the residual stream in the compute dtype; ``x_sum`` is the
    same value in f32 *before* its last rounding, or None.  The port keeps
    the precision the reference's compiled layer group has: XLA folds the
    bf16 rounding of an add into a following f32 convert, so a norm reads
    the residual add unrounded.  Each residual add returns both the
    rounded sum, which carries on, and the unrounded one, which the next
    norm reads.  ``shards``: the layer's ``modules.Shards`` (tensor
    parallel); ``cache_seq``: where the sequence of each of the layer's
    dense cache leaves splits (``attention.attention_block``).  Returns
    ``(x, x_sum, aux)``, aux the MoE block's load-balance loss (None
    without one)."""
    dt = _dtype(cfg.dtype)
    sh = (lambda k: None) if shards is None else (lambda k: shards[k])

    def add(a, b):
        s = a.float() + b.float()
        return s.to(dt), s

    hn = _norm(cfg, p["ln1"], x if x_sum is None else x_sum, dt)
    a, _ = attn.attention_block(
        p["attn"], cfg, hn, positions=positions, causal=causal,
        window=window, cache=cache, cache_index=cache_index,
        block_tables=block_tables, q_lens=q_lens, use_rope=use_rope,
        shards=sh("attn"), cache_seq=cache_seq)
    if cfg.post_block_norm:
        a = nn.rmsnorm(p["post_ln1"], a, cfg.norm_eps, out_dtype=dt)
    x, x_sum = add(x, a)
    if encoder_out is not None:
        hn = _norm(cfg, p["ln_cross"], x_sum, dt)
        c, _ = attn.attention_block(p["cross_attn"], cfg, hn,
                                    kv_override=encoder_out, use_rope=False,
                                    shards=sh("cross_attn"))
        x, x_sum = add(x, c)
    hn = _norm(cfg, p["ln2"], x_sum, dt)
    aux = None
    if "moe" in p:
        m, aux = moe_lib.moe_block(p["moe"], cfg, hn, shards=sh("moe"))
    else:
        m = nn.mlp(p["mlp"], hn, cfg.act, dtype=dt, sh=sh("mlp"))
    if cfg.post_block_norm:
        m = nn.rmsnorm(p["post_ln2"], m, cfg.norm_eps, out_dtype=dt)
    return add(x, m) + (aux,)


def _apply_mamba_layer(p, cfg, x, x_sum=None, cache=None, shards=None,
                       cache_specs=None):
    """Pre-norm mamba2 block plus the residual, with ``_apply_layer``'s
    ``(x, x_sum)`` convention: the norm reads ``x_sum`` (the residual
    before its last rounding) when given.  ``cache``: this layer's
    ``{"ssm", "conv"}`` decode state, updated in place (the engine's
    programs read it at its address).  ``shards``: the layer's params made
    whole (``Shards.replicate``) and the block run replicated; a state
    leaf that ``cache_specs`` splits over ``model`` (the SSM state by
    head, the conv state by channel) is all-gathered over ``model`` for
    the block, and the rank keeps its slice of the new state.  Returns
    ``(x, x_sum)``."""
    if shards is not None:
        p = shards.replicate(p)
    dt = _dtype(cfg.dtype)
    h = nn.rmsnorm(p["ln1"], x if x_sum is None else x_sum, cfg.norm_eps,
                   out_dtype=dt)
    split = {}
    state = cache
    if cache is not None and cache_specs is not None:
        from repro_torch.core import hvd
        from repro_torch.distributed.sharding import model_dim
        split = {k: model_dim(cache_specs[k]) for k in cache}
        state = {k: (t if split[k] is None else
                     hvd.gather_dim(t, split[k], shards.model))
                 for k, t in cache.items()}
    m, new_cache = ssm_lib.mamba2_block(p["mamba"], cfg, h, cache=state)
    if cache is not None:
        for name, t in new_cache.items():
            d = split.get(name)
            if d is not None:
                n = cache[name].shape[d]
                t = t.narrow(d, shards.model.rank * n, n)
            cache[name].copy_(t)
    s = x.float() + m.float()
    return s.to(dt), s


def _embed(params, cfg, tokens, shards=None):
    dt = _dtype(cfg.dtype)
    x = nn.embed(params["embed"], tokens, dtype=dt,
                 sh=None if shards is None else shards["embed"])
    if cfg.embed_scale:
        x = x * nn.const(math.sqrt(cfg.d_model), x)
    return x


def _run_layers(params, cfg, x, cache, *, positions, cache_index,
                block_tables, q_lens=None, long_context=False, shards=None,
                seq=None):
    """The dense, moe and vlm layer groups over a cache.  ``shards``: the
    ``layers`` subtree's (each group's params gathered over ``data``, the
    layers tensor parallel), ``seq`` the layers' ``cache_seq``."""
    windows = layer_pattern(cfg, long_context)
    groups = cfg.num_layers // len(windows)
    layers, lcache = params["layers"], cache["layers"]
    for gi in range(groups):
        gp = _index(layers, gi)
        if shards is not None:
            gp = shards.gather(gp)
        x_sum = None             # a group boundary rounds the stream
        for i, win in enumerate(windows):
            x, x_sum, _ = _apply_layer(
                _index(gp, i), cfg, x, x_sum, window=win,
                positions=positions, cache=_index(lcache, gi, i),
                cache_index=cache_index, block_tables=block_tables,
                q_lens=q_lens, shards=shards, cache_seq=seq)
    return x


def _vocab_shards(cfg, shards):
    """The ``Shards`` of the unembedding where it splits the vocabulary
    over ``model`` (the logits are then this rank's slice), else None."""
    if shards is None:
        return None
    sh = shards["embed"] if cfg.tie_embeddings else shards["lm_head"]
    leaf = "table" if cfg.tie_embeddings else "w"
    return sh if sh.dim(leaf) is not None else None


def _unembed(params, cfg, x, shards=None):
    """Final-norm hidden states -> f32 logits (final softcap applied);
    this rank's vocabulary slice where ``_vocab_shards`` says so."""
    vsh = _vocab_shards(cfg, shards)
    if cfg.tie_embeddings:
        logits = nn.unembed(params["embed"], x, sh=vsh)
    else:
        if vsh is not None:
            x = vsh.copy_in(x)
        logits = nn.linear(params["lm_head"], x,
                           dtype=_dtype(cfg.dtype)).float()
    return nn.softcap(logits, cfg.final_logit_softcap)


def _logits(params, cfg, x):
    return _unembed(params, cfg, _norm(cfg, params["final_norm"], x))


# ---------------------------------------------------------------------------
# Forward (train / prefill): the whole sequence, no cache
# ---------------------------------------------------------------------------

def _forward_group(gp, cfg, x, aux, positions=None, shards=None,
                   windows=None):
    """One layer group of the no-cache forward.  The residual enters the
    group rounded (the reference's scan carry) and the ``x_sum`` rule of
    ``_apply_layer`` holds inside it; each MoE layer's aux loss is added
    to ``aux`` in layer order (the reference's carry).  ``positions``: the
    vlm family's M-RoPE positions (3, B, S), else None (``arange``).
    ``shards``: the group's params are all-gathered over ``data`` here
    (inside the checkpointed call: the backward gathers them again) and
    the layers run tensor-parallel.  ``windows``: the group's
    ``layer_pattern`` (default: without the long-context variant).
    Returns ``(x, aux)``."""
    if shards is not None:
        gp = shards.gather(gp)
    x_sum = None
    for i, win in enumerate(windows or layer_pattern(cfg)):
        x, x_sum, a = _apply_layer(_index(gp, i), cfg, x, x_sum,
                                   window=win, positions=positions,
                                   cache=None, cache_index=None,
                                   block_tables=None, shards=shards)
        if a is not None:
            aux = aux + a
    return x, aux


def _encoder_layer(lp, cfg, x, shards=None):
    """One encoder layer (bidirectional, learned positions, no cache): one
    scan step of the reference's ``_encode``, so the residual enters it
    rounded and the ``x_sum`` rule holds inside it."""
    if shards is not None:
        lp = shards.gather(lp)
    return _apply_layer(lp, cfg, x, None, window=None, positions=None,
                        cache=None, cache_index=None, block_tables=None,
                        causal=False, use_rope=False, shards=shards)[0]


def _decoder_layer(lp, cfg, x, encoder_out, shards=None):
    """One encdec decoder layer of the no-cache forward (causal
    self-attention, cross-attention over ``encoder_out``, MLP): one scan
    step of the reference, with the ``x_sum`` rule across its three
    residual adds."""
    if shards is not None:
        lp = shards.gather(lp)
    return _apply_layer(lp, cfg, x, None, window=None, positions=None,
                        cache=None, cache_index=None, block_tables=None,
                        encoder_out=encoder_out, use_rope=False,
                        shards=shards)[0]


# ``remat_policy="dots"``: the reference's
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves every
# ``dot_general`` with no batch dims.  In the port those are the aten ops a
# product of an activation by a 2-D weight lowers to: ``aten.mm`` (``modules.
# linear`` / ``row_linear``: ``torch.matmul`` folds x (..., d_in) to 2-D, the
# reference's ``x @ w`` contracting d_in alone: the q, k, v and o
# projections, the cross-attention's K/V, the MLP's wi, wg and wo, the MoE
# router, mamba2's in and out projections) and ``aten.addmm`` (the same
# with its bias fused).  ``aten.bmm`` / ``baddbmm`` are recomputed: the MoE
# experts' einsums (batch dim e) and the plain attention's and SSD scan's
# (batch dims b, h), which carry batch dims in the reference too.  The
# kernels launch outside the dispatcher and are recomputed into fresh
# buffers like any other op.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


class DotsCounter(TorchDispatchMode):
    """While active, counts the ``_DOTS`` products by grad mode:
    ``grad_on`` (the forward, and a checkpoint's recompute in the
    backward) and ``grad_off`` (the gradients' own products)."""

    def __init__(self):
        super().__init__()
        self.grad_on = self.grad_off = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _DOTS:
            if torch.is_grad_enabled():
                self.grad_on += 1
            else:
                self.grad_off += 1
        return func(*args, **(kwargs or {}))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


_REMAT_POLICIES = ("nothing", "dots")


def _run(cfg, fn, p, *carry):
    """``fn(p, cfg, *carry)``, under ``torch.utils.checkpoint`` when
    ``cfg.remat``, as the reference's ``_scan_layers`` reads
    ``cfg.remat_policy``: ``"nothing"`` recomputes all of its activations
    in the backward, ``"dots"`` saves the outputs of its products with no
    batch dims (``_DOTS``) and recomputes the rest."""
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; the "
                         f"port runs {_REMAT_POLICIES}")
    if not cfg.remat:
        return fn(p, cfg, *carry)
    kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
    return checkpoint(fn, p, cfg, *carry, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _encode(enc_params, cfg, encoder_input, shards=None):
    """The encdec encoder over stub frame embeddings (B, encoder_seq, d):
    frames in the compute dtype plus the encoder's learned positions, its
    bidirectional layers (each under checkpoint with ``cfg.remat``), the
    encoder's final norm.  Returns (B, encoder_seq, d) in the compute
    dtype: the K/V source of every decoder layer's cross-attention.
    ``shards``: the encoder subtree's (tensor parallel)."""
    dt = _dtype(cfg.dtype)
    lsh = None
    if shards is not None:
        top = {k: v for k, v in enc_params.items() if k != "layers"}
        enc_params = dict(shards.gather(top), layers=enc_params["layers"])
        lsh = shards["layers"]
    x = encoder_input.to(dt)
    x = x + enc_params["pos_embed"][:x.shape[1]][None].to(dt)
    for lp in _unstack(enc_params["layers"]):
        x = _run(cfg, _encoder_layer, lp, x, lsh)
    return _norm(cfg, enc_params["final_norm"], x)


def _pos_rows(params, cfg, idx):
    """Learned position embeddings at positions ``idx``, in the compute
    dtype; positions past the table read its last row, as the reference's
    gather clamps them (a dense prefill chunk's padding tokens can run
    past it)."""
    table = params["pos_embed"]
    return table[idx.long().clamp(0, table.shape[0] - 1)].to(
        _dtype(cfg.dtype))


def _shared_block(p, cfg, x, x_sum, shards=None, window=None):
    """The hybrid family's shared attention + MLP block, no cache, at
    ``window`` (``_shared_window``).  Returns ``(x, x_sum)``."""
    if shards is not None:
        p = shards.gather(p)
    return _apply_layer(p, cfg, x, x_sum, window=window, positions=None,
                        cache=None, cache_index=None, block_tables=None,
                        shards=shards)[:2]


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
    for gi, group in enumerate(_unstack(params["layers"])):
        x_sum = None
        for i, lp in enumerate(_unstack(group)):
            x, x_sum = mamba(lp, x, x_sum, ("layers", gi, i))
        x, _ = shared(x, x_sum, gi)
    for li, lp in enumerate(_unstack(params["tail_layers"]) if R else ()):
        x, _ = mamba(lp, x, None, ("tail_layers", li))
    return x


def forward(params, cfg, batch: Dict[str, Any], *, last_only: bool = False,
            return_hidden: bool = False, shards: Optional[nn.Shards] = None,
            long_context: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward (training, prefill).  batch: tokens
    (B, S); for vlm also patch_embeddings (B, P, d), prepended to the
    text, and mrope_positions (3, B, P + S); for encdec encoder_input
    (B, encoder_seq, d), which ``_encode`` turns into the decoder's
    cross-attention source.  Returns (logits (B, S', V) f32, S' the whole
    sequence (patches included), aux_loss 0-d f32: the MoE layers'
    load-balance losses summed in layer order, zero for the other
    families).

    last_only: unembed only the final position.  return_hidden: return the
    final-norm hidden states (B, S, d) in the compute dtype instead of
    logits (kept for parity with the reference's ``forward``; the chunked
    loss runs ``_stack`` itself).  With ``cfg.remat``
    each layer group (dense), each mamba layer and each application of
    the hybrid family's shared block runs under ``torch.utils.checkpoint``
    (the reference remats whole scan steps; a hybrid group of six mamba
    layers and the shared block would hold all of their activations at
    once in the backward): its activations are recomputed in the
    backward, so attention or the SSD scan runs twice per layer per
    training step; under ``cfg.remat_policy="dots"`` the outputs of its
    products with no batch dims are saved instead (``_run``).

    ``shards``: the whole tree's ``modules.Shards`` (``dp_tp`` /
    ``fsdp_tp``; the params are this rank's slices).  The leaves outside
    the layer stacks are gathered over ``data`` once, up front; each layer
    group's inside its checkpointed call; the logits are this rank's
    vocabulary slice where the unembedding splits it (``_vocab_shards``).

    ``long_context``: the windows of ``layer_pattern(cfg, True)`` and, for
    the hybrid family, the shared block's ``_shared_window``."""
    check_trainable(cfg)
    params = _gather_top(params, shards)
    x, aux = _stack(params, cfg, batch, shards, long_context)
    if last_only:
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux
    return _unembed(params, cfg, x, shards), aux


def _stack(params, cfg, batch, shards=None, long_context: bool = False):
    """``forward`` from the embedding through the last layer (before the
    final norm), on params whose leaves outside the layer stacks are
    already gathered over ``data`` (``_gather_top``).  Returns ``(x,
    aux)``."""
    dt = _dtype(cfg.dtype)
    sh = (lambda k: None) if shards is None else (lambda k: shards[k])
    x = _embed(params, cfg, batch["tokens"], shards)
    positions = None
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeddings"].to(dt), x], dim=1)
        positions = batch["mrope_positions"]
    if cfg.max_pos_embed:
        x = x + params["pos_embed"][:x.shape[1]][None].to(dt)

    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "encdec":
        enc = _encode(params["encoder"], cfg, batch["encoder_input"],
                      sh("encoder"))
        for lp in _unstack(layers):
            x = _run(cfg, _decoder_layer, lp, x, enc, sh("layers"))
    elif cfg.family == "hybrid":
        def mamba(p, x, x_sum, where):
            return _run(cfg, _apply_mamba_layer, p, x, x_sum, None,
                        sh(where[0]))
        x = _hybrid_trunk(
            params, cfg, x, mamba,
            lambda x, x_sum, _: _run(cfg, _shared_block,
                                     params["shared_attn"], x, x_sum,
                                     sh("shared_attn"),
                                     _shared_window(cfg, long_context)))
    elif cfg.family == "ssm":
        for lp in _unstack(layers):
            x, _ = _run(cfg, _apply_mamba_layer, lp, x, None, None,
                        sh("layers"))
    else:
        windows = layer_pattern(cfg, long_context)
        for gp in _unstack(layers):
            x, aux = _run(cfg, _forward_group, gp, x, aux, positions,
                          sh("layers"), windows)
    return x, aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_metrics(loss, aux):
    return loss + aux, {"ce_loss": loss, "aux_loss": aux,
                        "perplexity": torch.exp(loss)}


def _text(cfg, x, labels):
    """Drop the vlm family's patch positions from the logits (or hidden
    states) and the labels: the loss covers the text alone."""
    if cfg.family == "vlm":
        return x[:, cfg.num_patches:], labels[:, cfg.num_patches:]
    return x, labels


def lm_loss(params, cfg, batch: Dict[str, Any],
            shards: Optional[nn.Shards] = None, *, long_context: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy (logits[t] predicts labels[t + 1]) over
    the full (B, S, V) f32 logits (the text positions only, for vlm), plus
    the MoE aux loss.  Returns (loss, metrics).  ``shards``: tensor
    parallel (``forward``); over a vocabulary split across ``model`` the
    cross-entropy is ``modules.vocab_parallel_nll``.  ``long_context``:
    ``forward``'s."""
    logits, aux = forward(params, cfg, batch, shards=shards,
                          long_context=long_context)
    logits, labels = _text(cfg, logits, batch["labels"])
    tgt = labels[:, 1:].long()
    vsh = _vocab_shards(cfg, shards)
    if vsh is not None:
        nll = nn.vocab_parallel_nll(logits[:, :-1].float(), tgt, vsh)
        return _loss_metrics(nll.mean(), aux)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return _loss_metrics(nll.mean(), aux)


def lm_loss_chunked(params, cfg, batch: Dict[str, Any],
                    shards: Optional[nn.Shards] = None, *,
                    seq_chunk: int = 512, long_context: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The same loss without the (B, S, V) logits: the trunk runs once,
    then each chunk of ``seq_chunk`` positions (``S - 1`` padded up to a
    multiple of it, the padding masked out) unembeds, takes logsumexp -
    target logit, and is recomputed in the backward (checkpointed, with
    the reference's default policy whatever ``cfg.remat_policy``), so the
    loss holds O(B * seq_chunk * V) at a time; the mean is over ``B * (S
    - 1)``.  ``shards``: as :func:`lm_loss`.  The leaves outside the
    layer stacks are gathered over ``data`` once and shared by the
    embedding and every chunk's unembedding (their gradients
    reduce-scattered once); each chunk's logits are this rank's
    vocabulary slice where it splits (``_vocab_shards``), its
    cross-entropy ``modules.vocab_parallel_nll``.  Every rank runs the
    same chunks in the same order."""
    check_trainable(cfg)
    params = _gather_top(params, shards)
    x, aux = _stack(params, cfg, batch, shards, long_context)
    x = _norm(cfg, params["final_norm"], x)
    x, labels = _text(cfg, x, batch["labels"])
    B, S, _ = x.shape
    x = x[:, :-1]
    tgt = labels[:, 1:].long()
    Sm = S - 1
    pad = (-Sm) % seq_chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad))
    valid = (torch.arange(Sm + pad, device=x.device) < Sm).float()
    vsh = _vocab_shards(cfg, shards)

    def chunk_nll(xc, tc, vc):
        logits = _unembed(params, cfg, xc, shards)
        if vsh is not None:
            return torch.sum(nn.vocab_parallel_nll(logits, tc, vsh) * vc)
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

def _gather_top(params, shards):
    """The leaves outside the layer stacks, gathered over ``data`` once
    (``fsdp_tp``); the identity without ``shards``."""
    if shards is None:
        return params
    stacks = ("layers", "tail_layers", "shared_attn", "encoder")
    return dict(params, **shards.gather({k: v for k, v in params.items()
                                         if k not in stacks}))


def gather_vocab(cfg, logits, shards=None):
    """Whole (.., V) logits from this rank's ``_unembed``: where the
    vocabulary splits over ``model`` the ranks' slices are all-gathered
    (counted), so every rank holds the reference's replicated output."""
    vsh = _vocab_shards(cfg, shards)
    if vsh is not None:
        from repro_torch.core import hvd
        logits = hvd.gather_dim(logits, -1, vsh.model)
    return logits


def _seq_split(shards, specs):
    """``{leaf: (group, index)}`` for each leaf of one attention cache
    whose sequence dim ``specs`` splits (the ``batch_pspec`` of a decode
    shape: over ``model`` where the KV heads do not divide it, over the
    data axes at B = 1): the group of those axes and this rank's slice
    index on them, row-major.  None where nothing splits."""
    from repro_torch.distributed import sharding as shd
    out = {}
    for name, spec in specs.items():
        entry = spec[-3] if name in ("k", "v") else spec[-2]
        axes = shd._axes(entry)
        if axes:
            out[name] = (shards.groups[axes],
                         shd._coord(shards.groups, axes)[0])
    return out or None


@torch.no_grad()
def decode_step(params, cfg, batch: Dict[str, Any], *,
                shards: Optional[nn.Shards] = None,
                long_context: bool = False) -> Tuple[torch.Tensor, Any]:
    """One-token decode.  batch: tokens (B, 1), positions (B,), cache,
    and optionally block_tables (B, blocks_per_slot).  Without tables the
    cache is the per-slot tree of ``init_cache`` (row b's token written
    at ``positions[b]``; a mamba layer's state advanced by one token);
    with them (dense, moe and vlm decoders) it is paged block storage.
    Either is updated in place.  Returns (logits (B, 1, V) f32, cache).
    The ssm, hybrid and encdec families take the per-slot cache only.
    encdec: ``encoder_output`` (B, encoder_seq, d), each row's encoder
    output, which every layer's cross-attention projects to K/V again
    (as the reference does), and the learned position at ``positions``.
    vlm: ``mrope_positions`` (3, B, 1) where given, else plain RoPE at
    ``positions`` (the reference's engine serves text this way).
    ``long_context``: the windows of ``layer_pattern(cfg, True)`` (and
    the hybrid shared block's ``_shared_window``).

    ``shards`` (the serve step under ``dp_tp`` / ``fsdp_tp``): the params
    are this rank's shards, the batch its rows and the dense cache its
    shard by ``shards.cache`` (the cache's specs, ``sharding.batch_pspec``)
    on ``shards.groups``.  The layers run as ``forward`` runs them (each
    group's params gathered over ``data``, tensor parallel over
    ``model``, a mamba layer replicated with its state gathered), the
    attention over the cache's layout (``attention.attention_block``),
    and the logits are whole on every rank (``gather_vocab``)."""
    _check_family(cfg, _FAMILIES)
    tokens, idx, cache = batch["tokens"], batch["positions"], batch["cache"]
    block_tables = batch.get("block_tables")
    if block_tables is not None:
        _refuse_paged(cfg)
        if shards is not None:
            raise NotImplementedError("a sharded serve step runs the dense "
                                      "per-slot cache")
    sh = (lambda k: None) if shards is None else (lambda k: shards[k])
    cspecs = None if shards is None else shards.cache
    params = _gather_top(params, shards)
    x = _embed(params, cfg, tokens, shards)
    if cfg.max_pos_embed:
        x = x + _pos_rows(params, cfg, idx)[:, None]
    positions = batch.get("mrope_positions")
    if positions is None:
        positions = idx[:, None]

    def seq(key):
        return None if cspecs is None else _seq_split(shards, cspecs[key])

    def gathered(p, key):
        return p if shards is None else shards[key].gather(p)

    if cfg.family in _POSITIONAL:
        x = _run_layers(params, cfg, x, cache, positions=positions,
                        cache_index=idx, block_tables=block_tables,
                        long_context=long_context, shards=sh("layers"),
                        seq=seq("layers"))
    elif cfg.family == "encdec":
        enc = batch["encoder_output"]
        for li in range(cfg.num_layers):
            x, _, _ = _apply_layer(
                gathered(_index(params["layers"], li), "layers"), cfg, x,
                None, window=None, positions=positions,
                cache=_index(cache["layers"], li), cache_index=idx,
                block_tables=None, encoder_out=enc, use_rope=False,
                shards=sh("layers"), cache_seq=seq("layers"))
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x, _ = _apply_mamba_layer(
                _index(params["layers"], li), cfg, x,
                cache=_index(cache["layers"], li), shards=sh("layers"),
                cache_specs=None if cspecs is None else cspecs["layers"])
    else:
        shared = gathered(params["shared_attn"], "shared_attn")
        win = _shared_window(cfg, long_context)
        x = _hybrid_trunk(
            params, cfg, x,
            lambda p, x, x_sum, where: _apply_mamba_layer(
                p, cfg, x, x_sum, cache=_index(cache[where[0]], *where[1:]),
                shards=sh(where[0]),
                cache_specs=None if cspecs is None else cspecs[where[0]]),
            lambda x, x_sum, gi: _apply_layer(
                shared, cfg, x, x_sum, window=win,
                positions=idx[:, None],
                cache=_index(cache["shared_attn"], gi), cache_index=idx,
                block_tables=None, shards=sh("shared_attn"),
                cache_seq=seq("shared_attn"))[:2])
    logits = _unembed(params, cfg, _norm(cfg, params["final_norm"], x),
                      shards)
    return gather_vocab(cfg, logits, shards), cache


# ---------------------------------------------------------------------------
# Paged chunked-prefill step (a (B, C) query tile against block storage)
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, cfg, batch: Dict[str, Any], *,
                 long_context: bool = False) -> Tuple[torch.Tensor, Any]:
    """One chunk of batched paged prefill: ``C`` tokens for every row.

    batch: tokens (B, C); positions (B,) — each row's *start* position;
    q_lens (B,) — valid tokens per row (padding tokens and rows are masked
    and their K/V routed to the trash block); cache — paged block storage,
    updated in place; block_tables (B, blocks_per_slot).  Returns
    (logits (B, C, V) f32, cache); logits at padding positions are
    garbage — callers index only real tokens, but every row of the tile
    runs the MoE block and so counts against expert capacity, as in the
    reference.  Dense and moe decoders only: the ssm and hybrid families
    raise ``ValueError``, as in the reference.  ``long_context``: the
    windows of ``layer_pattern(cfg, True)``."""
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
                    q_lens=batch["q_lens"], long_context=long_context)
    return _logits(params, cfg, x), cache
