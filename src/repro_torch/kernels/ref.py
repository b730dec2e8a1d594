"""Plain PyTorch versions of the paged attention kernels (the allclose targets).

Counterparts of ``repro.kernels.ref.paged_attention_ref`` and
``paged_prefill_ref``: gather every row's pages back into a dense
``(B, T, KV, D)`` layout, then run naive masked softmax attention in f32.
Fully masked rows return zeros (the kernels' semantics).  The mask
sentinel is the kernels' ``-1e30``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1.0e30


def _gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(NP, page, KV, D) pages through (B, pps) tables -> (B, T, KV, D)."""
    NP, page, KV, D = pages.shape
    B, pps = tables.shape
    idx = tables.to(torch.long).clamp(0, NP - 1).reshape(-1)
    return pages[idx].reshape(B, pps * page, KV, D)


def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q: (B, KV, G, D); k_pages, v_pages: (NP, page, KV, D);
    block_tables: (B, pps) int; lengths: (B,) valid positions including
    the current token.  Returns (B, KV, G, D) in q's dtype."""
    B, KV, G, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    T = k.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) * scale
    s = _softcap(s, softcap)
    kpos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.to(torch.long).to(q.device)[:, None]
    mask = kpos < lens                                   # causal: q is last
    if window is not None:
        mask &= (lens - 1) - kpos < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    any_valid = mask.any(dim=1)[:, None, None, None]
    return torch.where(any_valid, out, torch.zeros_like(out)).to(q.dtype)


def paged_prefill_ref(q, k_pages, v_pages, block_tables, start_pos, q_lens,
                      *, scale: Optional[float] = None,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None):
    """q: (B, C, KV, G, D) chunk of query tokens per row; pages hold the
    chunk's own K/V at its absolute positions; start_pos: (B,) position of
    each row's first query; q_lens: (B,) valid query tokens per row
    (padding rows and tokens return zeros).  Returns (B, C, KV, G, D)."""
    B, C, KV, G, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    T = k.shape[1]
    dev = q.device
    s = torch.einsum("bckgd,btkd->bkgct", q.float(), k) * scale
    s = _softcap(s, softcap)
    cidx = torch.arange(C, device=dev)
    qpos = start_pos.to(torch.long).to(dev)[:, None] + cidx[None, :]
    kpos = torch.arange(T, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]                      # causal (B, C, T)
    mask &= (cidx[None, :]
             < q_lens.to(torch.long).to(dev)[:, None])[:, :, None]
    if window is not None:
        mask &= (qpos[:, :, None] - kpos) < window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", p, v)
    any_valid = mask.any(dim=2)[:, :, None, None, None]
    return torch.where(any_valid, out, torch.zeros_like(out)).to(q.dtype)
