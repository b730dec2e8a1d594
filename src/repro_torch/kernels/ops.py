"""Model-facing wrappers around the kernels.

Counterparts of ``repro.kernels.ops.mha_flash_attention``,
``paged_decode_attention``, ``paged_prefill_attention``, ``ssd`` and
``rmsnorm``, and ``int8kv_attention`` (the reference has no ops wrapper
for its int8 flash kernel; the port's dense int8 decode calls this).
The paged wrappers do the reference's head folding (decode
``(B, 1, H, D) -> (B, KV, G, D)``; prefill
``(B, C, H, D) -> (B, KV, C*G, D)`` with row ``c*G + g``); the flash,
int8 flash and SSD kernels read the model layout themselves.  The kernel
modules launch the CUDA kernel for a CUDA tensor and run the plain
PyTorch version for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import pad_to_chunks


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


def int8kv_attention(q, k8, k_scale, v8, v_scale, q_start, kv_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """Model-layout causal attention over an int8 K/V cache (forward only).

    q: (B, Sq, H, D), H = G * KV; k8, v8: (B, Skv, KV, D) int8 (not
    repeated per group); k_scale, v_scale: (B, Skv, KV) per-token scales;
    q_start: (B,) position of each row's first query; kv_len: (B,) keys
    valid per row (decode: ``q_start = pos``, ``kv_len = pos + 1``).
    Returns (B, Sq, H, D) in q's dtype.  The kernel takes the scales in
    q's dtype: the cache's bf16 scales widen exactly for an f32 model.
    ``return_lse``: ``(out, lse (B, Sq, H) f32)``, each row's log-sum-exp
    (the merge of sequence slices, ``attention.merge_slices``)."""
    return _fa.flash_attention_int8kv(
        q.contiguous(), k8, k_scale.to(q.dtype), v8, v_scale.to(q.dtype),
        q_start.to(torch.int32).contiguous(),
        kv_len.to(torch.int32).contiguous(), causal=True, window=window,
        softcap=softcap, scale=scale, return_lse=return_lse)


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


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """Model-layout SSD scan, differentiable.

    x: (b, S, H, P); dt: (b, S, H) f32; A: (H,) f32; B, C: (b, S, G, N),
    G | H (B and C are not repeated per head).  Returns y (b, S, H, P) in
    x's dtype.  S is padded to a multiple of ``L = min(chunk, S)`` with
    dt = 0, which leaves the state and the outputs unchanged (as
    ``ssd_chunked`` pads), so the kernel keeps the TPU kernel's
    ``S % L == 0`` contract.  The backward is the plain version's."""
    S = x.shape[1]
    L = min(chunk, S)
    x, dt, B, C = pad_to_chunks(x, dt, B, C, L)
    y = _ssd.SSDScan.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                           B.contiguous(), C.contiguous(), L)
    return y[:, :S]


def rmsnorm(x, scale, *, eps: float = 1e-6,
            out_dtype: Optional[torch.dtype] = None):
    """x (..., d) * rsqrt(mean(x^2) + eps) * (1 + scale), in f32, out in
    ``out_dtype`` (default: x's dtype); differentiable (PyTorch
    backward)."""
    return _rn.RMSNorm.apply(x, scale, float(eps), out_dtype or x.dtype)
