"""Model-facing wrappers around the attention kernels.

Counterparts of ``repro.kernels.ops.mha_flash_attention``,
``paged_decode_attention`` and ``paged_prefill_attention``.  The paged
wrappers do the reference's head folding (decode
``(B, 1, H, D) -> (B, KV, G, D)``; prefill ``(B, C, H, D) -> (B, KV, C*G, D)``
with row ``c*G + g``); the flash kernel reads the model layout itself.  The
kernel modules launch the CUDA kernel for a CUDA tensor and run the plain
PyTorch version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_prefill as _pp


def mha_flash_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """Model-layout flash attention, differentiable.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H = G * KV (GQA; K/V are
    not repeated per group).  Returns (B, Sq, H, D) in q's dtype.  The
    forward runs the flash kernel (plain version on the CPU); the backward
    is ``flash_attention.flash_attention_bwd``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fa.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, softcap,
                                    float(scale))


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None):
    """q: (B, 1, H, D), H = G * KV; k_pages, v_pages: (NP, page, KV, D);
    block_tables: (B, pps) int32; lengths: (B,) valid positions including
    the current token.  Returns (B, 1, H, D)."""
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError("paged attention is single-token decode")
    KV = k_pages.shape[2]
    G = H // KV
    qf = q[:, 0].reshape(B, KV, G, D).contiguous()
    out = _pa.paged_attention(
        qf, k_pages, v_pages, block_tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), window=window,
        softcap=softcap, scale=scale)
    return out.reshape(B, 1, H, D)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, start_pos,
                            q_lens, *, window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """q: (B, C, H, D), H = G * KV; pages hold the chunk's own K/V;
    block_tables: (B, pps) int32; start_pos: (B,) position of each row's
    first query; q_lens: (B,) valid query tokens per row (rows/tokens past
    q_lens are padding and return zeros).  Returns (B, C, H, D)."""
    B, C, H, D = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    # fold (C, G) -> CG rows grouped per KV head: row c*G+g
    qf = q.reshape(B, C, KV, G, D).transpose(1, 2).reshape(B, KV, C * G, D)
    out = _pp.paged_prefill(
        qf.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        start_pos.to(torch.int32).contiguous(),
        q_lens.to(torch.int32).contiguous(), group=G, window=window,
        softcap=softcap, scale=scale)
    return out.reshape(B, KV, C, G, D).transpose(1, 2).reshape(B, C, H, D)
