"""Attention: GQA + RoPE + sliding window + logit softcap.

Counterpart of ``repro.models.attention``.  Two branches of
``attention_block`` are ported:
- no cache (the full-sequence ``forward`` of training): projections, RoPE,
  then the differentiable flash attention (``kernels.ops.
  mha_flash_attention``: the CUDA flash kernel forward, a PyTorch
  backward), where the reference runs the query-chunked jnp ``attend``;
- paged KV (the serving path): this step's K/V are scattered into block
  storage through the block tables, in place, and attention gathers them
  back through the CUDA paged kernels.
The dense-cache branch waits for dense-mode serving and cross-attention
for the enc-dec family (ROADMAP Queue 1 items 6 and 11).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import modules as nn

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """positions: (B, S).  Returns (B, S, head_dim/2) f32 angles."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)                              # (half,)
    return positions.float()[..., None] * inv_freq[None, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Half-split rotation in f32,
    cast back to x's dtype.  (M-RoPE joins with the VLM slice.)"""
    half = x.shape[-1] // 2
    ang = _rope_angles(positions, x.shape[-1], theta)
    cos = torch.cos(ang)[:, :, None, :]                           # (B,S,1,half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + paged attend)
# ---------------------------------------------------------------------------

def attention_block(params, cfg, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    cache=None, cache_index: Optional[torch.Tensor] = None,
                    kv_override=None, use_rope: bool = True,
                    block_tables: Optional[torch.Tensor] = None,
                    q_lens: Optional[torch.Tensor] = None):
    """x: (B, S, d_model).  Returns (out, cache).

    No cache (``cache is None``): causal self-attention over the whole
    sequence (top-left: query t sees keys <= t, within ``window``), with
    ``cfg.attn_logit_softcap``; differentiable.

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
    """
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention is ported with the enc-dec family (ROADMAP "
            "Queue 1 item 11)")
    if cache is not None and block_tables is None:
        raise NotImplementedError(
            "attention over a dense per-slot cache is ported with dense-mode "
            "serving (ROADMAP Queue 1 item 6); pass block_tables (paged KV)")
    B, S, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    q = nn.linear(params["wq"], x, dtype=dt)                     # (B,S,h,dh)
    k = nn.linear(params["wk"], x, dtype=dt)                     # (B,S,kv,dh)
    v = nn.linear(params["wv"], x, dtype=dt)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    scale = cfg.attn_scale or (1.0 / math.sqrt(dh))
    sc = cfg.attn_logit_softcap
    if cache is None:
        out = kops.mha_flash_attention(q, k, v, causal=True, window=window,
                                       softcap=sc, scale=scale)
        out = nn.linear(params["wo"], out.reshape(B, S, h * dh), dtype=dt)
        return out, None
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
