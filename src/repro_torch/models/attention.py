"""Attention: GQA + RoPE + sliding window + logit softcap.

Counterpart of ``repro.models.attention``.  Three branches of
``attention_block`` are ported:
- no cache (the full-sequence ``forward`` of training): projections, RoPE,
  then the differentiable flash attention (``kernels.ops.
  mha_flash_attention``: the CUDA flash kernel forward, a PyTorch
  backward), where the reference runs the query-chunked jnp ``attend``;
- paged KV (the paged serving path): this step's K/V are scattered into
  block storage through the block tables, in place, and attention gathers
  them back through the CUDA paged kernels;
- a dense per-slot cache (dense-mode serving): this step's K/V are
  written at each row's position in place; a bf16 cache is attended by
  the plain query-chunked ``attend`` (as in the reference, which runs no
  kernel there), an int8 cache (``quantize_kv``) by the CUDA int8 flash
  kernel (``kernels.ops.int8kv_attention``);
- cross-attention (``kv_override``, the encdec decoder): K/V projected
  from the encoder output on every call, no RoPE, no cache, attended
  without a mask by the flash kernel (``causal=False``), in training and
  serving alike.  The encoder's self-attention is the no-cache branch
  with ``causal=False``.
RoPE takes M-RoPE positions (3, B, S) for the vlm family (qwen2-vl).

Tensor parallelism (given a ``modules.Shards``): the rank's query heads
are ``wq``'s local columns,
and the head counts come from the weights' shapes.  Where ``wk`` / ``wv``
split over ``model`` too, each rank attends its H / m query heads with
its KV / m heads.  Where the KV heads do not split (``fit_spec`` dropped
``model``: gemma2-27b's smoke config has 2 KV heads over a model axis of
4) while the query heads do, the rank computes every KV head and attends
with the ones its query heads' groups read.  Where the query heads do not
split either, the attention is replicated, and ``wo`` (whose h * dh rows
``fit_spec`` checks on their own) may still be row-parallel:
``modules.row_linear`` then takes its slice of the whole output.

A sharded dense decode cache (the serve step under ``dp_tp`` /
``fsdp_tp``; ``sharding.batch_pspec`` lays it out) takes one of three
layouts, read from its leaves' specs: (a) the KV heads over ``model``:
the rank projects its heads, writes its stripe and attends, as
unsharded; (b) the sequence over a group (``model`` where the KV heads
do not divide it, the data axes at B = 1): the rank holds a contiguous
slice of every position range, the step's K/V are written by the rank
whose slice holds the position (a masked in-place write), every rank
attends all its query heads over its slice at global key positions, and
the slices are merged exactly by the log-sum-exp rule over the group
(:func:`merge_slices`); (c) unsharded.  Under (b) over ``model`` the
query heads are gathered whole first where ``wq`` splits them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import modules as nn

NEG_INF = -2.0e38

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections=None) -> torch.Tensor:
    """positions: (B, S), or (3, B, S) for M-RoPE.  Returns (B, S,
    head_dim/2) f32 angles.  With 3-D positions frequency i takes the
    position row of its section (0 temporal, 1 height, 2 width;
    ``mrope_sections`` frequencies each, summing to head_dim/2); 2-D
    positions give plain RoPE whatever the config says (the reference's
    decode passes (B, 1))."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)                              # (half,)
    if positions.dim() == 3:                                      # M-RoPE
        if mrope_sections is None or sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"split head_dim/2 = {half}")
        sec_id = torch.repeat_interleave(
            torch.arange(len(mrope_sections), device=positions.device),
            torch.tensor(mrope_sections, device=positions.device),
            output_size=half)
        pos = positions[sec_id].permute(1, 2, 0).float()         # (B,S,half)
        return pos * inv_freq
    return positions.float()[..., None] * inv_freq[None, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, mrope_sections=None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (3, B, S) (M-RoPE, with
    ``mrope_sections``).  Half-split rotation in f32, cast back to x's
    dtype."""
    half = x.shape[-1] // 2
    ang = _rope_angles(positions, x.shape[-1], theta, mrope_sections)
    cos = torch.cos(ang)[:, :, None, :]                           # (B,S,1,half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Core chunked GQA attention (plain PyTorch)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive f32 bias.  q_pos: (Sq,) or (B, Sq); k_pos: (Skv,).
    Returns (Sq, Skv) or (B, Sq, Skv)."""
    qp = q_pos[..., :, None].long()
    kp = k_pos[None, :].long()
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= (qp - kp) < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(m, zero, torch.full_like(zero, NEG_INF))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, window: Optional[int] = None,
           softcap_val: Optional[float] = None,
           q_positions: Optional[torch.Tensor] = None,
           k_positions: Optional[torch.Tensor] = None,
           q_chunk: int = 512) -> torch.Tensor:
    """Query-chunked softmax attention (the reference's ``attend``).

    q: (B, Sq, KV, G, D); k, v: (B, Skv, KV, D).  q_positions: (Sq,) or
    (B, Sq) absolute positions; k_positions: (Skv,).  Scores in f32 from
    the operands' values, softmax in f32, P.V in f32, out in q's dtype.
    Returns (B, Sq, KV, G, D)."""
    Sq, Skv = q.shape[1], k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if k_positions is None:
        k_positions = torch.arange(Skv, device=dev)
    kf, vf = k.float(), v.float()

    def chunk_body(q_blk, qpos_blk):
        s = torch.einsum("bqkgd,btkd->bkgqt", q_blk.float(), kf) * scale
        s = nn.softcap(s, softcap_val)
        bias = _mask_bias(qpos_blk, k_positions, causal=causal,
                          window=window)
        if bias.dim() == 3:                               # batched positions
            bias = bias[:, None, None]                    # (B,1,1,Sq,Skv)
        p = torch.softmax(s + bias, dim=-1)
        return torch.einsum("bkgqt,btkd->bqkgd", p, vf).to(q.dtype)

    if q_chunk <= 0 or Sq <= q_chunk or Sq % q_chunk != 0:
        return chunk_body(q, q_positions)
    outs = [chunk_body(q[:, c0:c0 + q_chunk],
                       q_positions[..., c0:c0 + q_chunk])
            for c0 in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, window: Optional[int],
                   softcap_val: Optional[float], q_positions: torch.Tensor,
                   k_positions: torch.Tensor):
    """Causal attention of ``q`` over one slice of the keys, for an exact
    merge of slices (:func:`merge_slices`).  q: (B, Sq, KV, G, D); k, v:
    (B, n, KV, D) at global positions ``k_positions`` (n,); q_positions
    (B, Sq).  Returns (out (B, Sq, KV * G, D) f32, normalised over the
    slice, lse (B, Sq, KV * G) f32, the log-sum-exp of the row's masked
    scores); a row with no valid key in the slice has out 0 and lse
    -inf."""
    B, Sq, KV, G, D = q.shape
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    s = nn.softcap(s, softcap_val)
    qp = q_positions[:, None, None, :, None].long()
    kp = k_positions.long()
    ok = kp <= qp
    if window is not None:
        ok = ok & ((qp - kp) < window)
    s = torch.where(ok, s, torch.full_like(s, float("-inf")))
    lse = torch.logsumexp(s, dim=-1)                        # (B,KV,G,Sq)
    live = ok.any(dim=-1)
    p = torch.exp(s - torch.where(live, lse, 0.0)[..., None])
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    lse = torch.where(live, lse, float("-inf"))
    return (out.reshape(B, Sq, KV * G, D),
            lse.permute(0, 3, 1, 2).reshape(B, Sq, KV * G))


def merge_slices(out: torch.Tensor, lse: torch.Tensor, group
                 ) -> torch.Tensor:
    """The exact merge of the ranks' attention over their key slices:
    ``out`` (..., D) normalised over this rank's slice and ``lse`` (...)
    its log-sum-exp (-inf: no valid key here, which contributes zero).
    One all_reduce of the max over ``group``, then one of the rescaled
    outputs and weights together (both counted, ``core/hvd.py``).
    Returns the whole attention (..., D) in f32."""
    from repro_torch.core import hvd
    m = hvd.all_reduce_max(lse, group)
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    packed = hvd.reduce_from_group(packed, group)
    den = packed[..., -1:]
    return torch.where(den > 0, packed[..., :-1] / den.clamp(min=1e-30),
                       0.0)


# ---------------------------------------------------------------------------
# The dense decode cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """Per-(token, kv head) absmax int8 quantization, the reference's:
    scale = max |x| / 127 + 1e-8 in f32, codes round(x / scale) (half to
    even, as ``jnp.round``).  x: (..., D).  Returns (codes int8 (..., D),
    scales bf16 (...))."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    return torch.round(xf / s[..., None]).to(torch.int8), \
        s.to(torch.bfloat16)


def _write_rows(cache, rows: torch.Tensor, idx: torch.Tensor,
                vals, lo=None) -> None:
    """``cache[name][rows, idx] = val`` in place for each (name, val),
    dropping rows whose ``idx`` is past the cache, as the reference's
    scatter drops out-of-bounds updates (dense prefill replays its padding
    tokens there).  ``lo``: ``{name: first position}`` of a leaf that
    holds one slice of the sequence, whose rank writes only the rows
    whose position falls in it.  No host sync."""
    for name, val in vals:
        leaf = cache[name]
        S = leaf.shape[1]
        local = idx - (lo or {}).get(name, 0)
        inside = (local >= 0) & (local < S)
        safe = local.clamp(0, S - 1)
        mask = inside.reshape((-1,) + (1,) * (val.dim() - 1))
        leaf.index_put_((rows, safe), torch.where(
            mask, val.to(leaf.dtype), leaf[rows, safe]))


def _dense_decode(cache, q, k, v, idx, *, scale, window, softcap, q_chunk):
    """Write this step's k/v (B, 1, KV, D) at position ``idx[b]`` of each
    row's stripe, in place, and attend the query (B, 1, H, D) over the
    stripe.  Returns (B, 1, H, D)."""
    B, _, KV, D = k.shape
    rows = torch.arange(B, device=q.device)
    if "k_scale" in cache:
        k8, ks = quantize_kv(k[:, 0])
        v8, vs = quantize_kv(v[:, 0])
        _write_rows(cache, rows, idx, (("k", k8), ("v", v8),
                                       ("k_scale", ks), ("v_scale", vs)))
        return kops.int8kv_attention(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            idx, idx + 1, window=window, softcap=softcap, scale=scale)
    _write_rows(cache, rows, idx, (("k", k[:, 0]), ("v", v[:, 0])))
    H = q.shape[2]
    out = attend(q.reshape(B, 1, KV, H // KV, D), cache["k"], cache["v"],
                 scale=scale, causal=True, window=window,
                 softcap_val=softcap, q_positions=idx[:, None],
                 k_positions=torch.arange(cache["k"].shape[1],
                                          device=q.device),
                 q_chunk=q_chunk)
    return out.reshape(B, 1, H, D)


def _split_decode(cache, seq, q, k, v, idx, *, scale, window, softcap):
    """Layout (b) of the module's docstring: ``cache`` holds this rank's
    slice of the sequence of each leaf ``seq`` names (``{leaf: (group,
    index)}``; the others whole), q (B, 1, H, D) all the heads the rank
    attends, k / v (B, 1, KV, D) this step's.  The step's K/V (quantized
    first for int8) are written by the rank whose slice holds
    ``idx[b]``; the rank attends over the K slice (the plain
    ``attend_partial`` for bf16, the int8 kernel with ``q_start`` and
    ``kv_len`` rebased to the slice, which returns the row log-sum-exp
    too) and the slices are merged over the K leaf's group.  Returns
    (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    rows = torch.arange(B, device=q.device)
    lo = {name: index * cache[name].shape[1]
          for name, (_, index) in seq.items()}
    n = cache["k"].shape[1]
    k_lo = lo.get("k", 0)
    if "k_scale" in cache:
        k8, ks = quantize_kv(k[:, 0])
        v8, vs = quantize_kv(v[:, 0])
        _write_rows(cache, rows, idx, (("k", k8), ("v", v8),
                                       ("k_scale", ks), ("v_scale", vs)),
                    lo)

        def scales(name):        # the scales of the K slice's positions
            s0 = k_lo - lo.get(name, 0)
            return cache[name][:, s0:s0 + n].contiguous()
        out, lse = kops.int8kv_attention(
            q, cache["k"], scales("k_scale"), cache["v"], scales("v_scale"),
            (idx - k_lo).clamp(min=0), (idx + 1 - k_lo).clamp(0, n),
            window=window, softcap=softcap, scale=scale, return_lse=True)
    else:
        _write_rows(cache, rows, idx, (("k", k[:, 0]), ("v", v[:, 0])), lo)
        out, lse = attend_partial(
            q.reshape(B, 1, KV, H // KV, D), cache["k"], cache["v"],
            scale=scale, window=window, softcap_val=softcap,
            q_positions=idx[:, None],
            k_positions=torch.arange(k_lo, k_lo + n, device=q.device))
    if "k" in seq:
        out = merge_slices(out, lse, seq["k"][0])
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + attend [+ cache])
# ---------------------------------------------------------------------------

def _local_kv(shards, k, v, h_local: int, group: int):
    """The KV heads this rank's ``h_local`` query heads read, from every
    KV head (computed replicated): query head j reads KV head j // group.
    A contiguous run of KV heads where ``h_local`` is a multiple of the
    group, else one KV head per query head (MHA locally).  The KV heads
    enter the sharded region here, so their gradient is the ranks' sum."""
    lo = shards.model.rank * h_local
    k, v = shards.copy_in(k), shards.copy_in(v)
    if h_local % group == 0:
        sl = slice(lo // group, (lo + h_local) // group)
        return k[:, :, sl], v[:, :, sl]
    idx = (lo + torch.arange(h_local, device=k.device)) // group
    return k[:, :, idx], v[:, :, idx]


def attention_block(params, cfg, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: Optional[int] = None,
                    cache=None, cache_index: Optional[torch.Tensor] = None,
                    kv_override=None, use_rope: bool = True,
                    block_tables: Optional[torch.Tensor] = None,
                    q_lens: Optional[torch.Tensor] = None,
                    shards: Optional[nn.Shards] = None,
                    cache_seq=None):
    """x: (B, S, d_model).  Returns (out, cache).

    positions: (B, S), or (3, B, S) M-RoPE positions (vlm); default
    ``arange(S)`` per row.

    No cache (``cache is None``): self-attention over the whole sequence,
    causal (top-left: query t sees keys <= t, within ``window``) unless
    ``causal=False`` (the encoder), with ``cfg.attn_logit_softcap``;
    differentiable.

    Cross-attention (``kv_override`` (B, Skv, d), the encoder output):
    K/V projected from it, no RoPE, no cache (``cache`` is ignored, as in
    the reference), every query sees every key; differentiable.

    Dense cache (``block_tables is None``): ``cache`` holds one layer's
    per-slot stripes ``{"k": (B, Smax, KV, D), "v": ...}`` (bf16), or int8
    codes plus ``k_scale`` / ``v_scale`` (B, Smax, KV) bf16; S must be 1
    and this step's K/V land at ``cache_index[b]``, in place (quantized
    first for int8), before the query at that position attends keys
    ``<= cache_index[b]``.

    Paged mode: ``cache`` holds one layer's block storage
    ``{"k": (num_blocks, block_size, KV, D), "v": ...}`` and
    ``block_tables`` (B, blocks_per_slot) maps each row's positions to
    blocks.  S == 1 is single-token decode at position ``cache_index[b]``;
    S > 1 is a chunked-prefill tile whose row b starts at
    ``cache_index[b]`` with ``q_lens[b]`` valid tokens.  This step's K/V are
    written into the storage **in place** (``index_put_``, where the
    reference donated the buffers to a jitted update); padding tokens —
    ``t >= q_lens[b]`` or positions past the table — go to the trailing
    trash block ``num_blocks - 1``.  The returned cache is the same
    object.

    ``shards`` (``dp_tp`` / ``fsdp_tp``): this rank's heads, as the
    module's docstring says: the no-cache and cross-attention branches,
    and the dense cache in the layouts there, ``cache_seq`` (``{leaf:
    (group, index)}``) naming the leaves whose sequence splits (layout
    (b); None: layout (a) or (c)).
    """
    B, S, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    kv_src = x if kv_override is None else kv_override.to(dt)
    q_split = shards is not None and shards.dim("wq", "w") is not None
    kv_split = shards is not None and shards.dim("wk", "w") is not None
    # x enters the sharded region once (one all_reduce of its gradient)
    xm = shards.copy_in(x) if q_split or kv_split else x
    q = nn.linear(params["wq"], xm if q_split else x, dtype=dt)  # (B,S,h,dh)
    if kv_override is None:
        kv_in = xm if kv_split else x
    else:
        kv_in = shards.copy_in(kv_src) if kv_split else kv_src
    k = nn.linear(params["wk"], kv_in, dtype=dt)               # (B,Skv,kv,dh)
    v = nn.linear(params["wv"], kv_in, dtype=dt)
    if use_rope and kv_override is None:
        sections = cfg.mrope_sections if cfg.mrope else None
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)
    seq_model = bool(cache_seq) and "k" in cache_seq and \
        "model" in cache_seq["k"][0].axes
    if q_split and not kv_split and not seq_model:
        k, v = _local_kv(shards, k, v, q.shape[2], h // kv)

    scale = cfg.attn_scale or (1.0 / math.sqrt(dh))
    sc = cfg.attn_logit_softcap
    if cache is None or kv_override is not None:
        out = kops.mha_flash_attention(
            q, k, v, causal=causal and kv_override is None, window=window,
            softcap=sc, scale=scale)
        out = nn.row_linear(params["wo"], out.reshape(B, S, -1), dtype=dt,
                            sh=None if shards is None else shards["wo"])
        return out, None
    if shards is not None and block_tables is not None:
        raise NotImplementedError("a sharded attention block runs the "
                                  "dense cache, not paged storage")
    if block_tables is None:
        if S != 1:
            raise ValueError("the dense cache is one-token decode")
        idx = cache_index.to(torch.long)
        if cache_seq:
            if seq_model and q_split:      # every head, on every rank
                from repro_torch.core import hvd
                q = hvd.gather_dim(q, 2, shards.model)
            out = _split_decode(cache, cache_seq, q, k, v, idx, scale=scale,
                                window=window, softcap=sc)
        else:
            out = _dense_decode(cache, q, k, v, idx, scale=scale,
                                window=window, softcap=sc,
                                q_chunk=cfg.attn_q_chunk)
        out = nn.row_linear(params["wo"], out.reshape(B, S, -1), dtype=dt,
                            sh=None if shards is None else shards["wo"])
        return out, cache
    kc, vc = cache["k"], cache["v"]
    npages, bs = kc.shape[0], kc.shape[1]
    bps = block_tables.shape[1]
    idx = cache_index.to(torch.long)                             # (B,)
    rows = torch.arange(B, device=x.device)
    tables = block_tables.to(torch.long)
    if S == 1:
        # paged decode: scatter this step's k/v through the table, then
        # gather-attend with the decode kernel (bf16 pages go in as-is)
        blk = tables[rows, (idx // bs).clamp(0, bps - 1)]
        off = idx % bs
        kc.index_put_((blk, off), k[:, 0].to(kc.dtype))
        vc.index_put_((blk, off), v[:, 0].to(vc.dtype))
        out = kops.paged_decode_attention(
            q, kc, vc, block_tables, cache_index + 1, window=window,
            softcap=sc, scale=scale)
    else:
        # paged chunked prefill: the whole (B, S) tile's k/v go straight
        # into each row's pool blocks; padding tokens (past q_lens, or
        # past the table's extent) land in the trailing trash block
        qlv = (torch.full((B,), S, dtype=torch.long, device=x.device)
               if q_lens is None else q_lens.to(torch.long))
        t = torch.arange(S, device=x.device)[None]
        pos = idx[:, None] + t                                   # (B, S)
        valid = (t < qlv[:, None]) & (pos < bps * bs)
        blk = torch.where(
            valid, tables[rows[:, None], (pos // bs).clamp(0, bps - 1)],
            torch.full_like(pos, npages - 1))
        off = pos % bs
        kc.index_put_((blk, off), k.to(kc.dtype))
        vc.index_put_((blk, off), v.to(vc.dtype))
        out = kops.paged_prefill_attention(
            q, kc, vc, block_tables, cache_index, qlv, window=window,
            softcap=sc, scale=scale)
    out = nn.linear(params["wo"], out.reshape(B, S, h * dh), dtype=dt)
    return out, cache
