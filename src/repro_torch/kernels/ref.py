"""Plain PyTorch versions of the kernels (the allclose targets).

Counterparts of ``repro.kernels.ref``: ``attention_ref`` (dense attention,
the flash kernel's oracle), ``paged_attention_ref`` and
``paged_prefill_ref`` (gather every row's pages back into a dense
``(B, T, KV, D)`` layout) and ``attention_int8kv_ref`` (int8 K/V with
per-token scales, per-row query positions): naive masked softmax
attention in f32.  Fully
masked rows return zeros (the kernels' semantics).  The mask sentinel is
the kernels' ``-1e30``; the reference's jnp ``attention.attend`` masks
with ``-2e38`` instead, which gives the same values wherever a row has a
valid key.  ``ssd_scan_ref`` is the chunked SSD scan (the reference's
``models.ssm.ssd_chunked``) and ``rmsnorm_ref`` the fused norm's
function.

Used by the tests and ``chip_smoke.py`` only, to hold the kernels'
designs and stated rounding: ``paged_split_ranges`` and
``paged_attention_split_ref`` (the split-context decode kernel's page
ranges and its split-and-combine, in f32), ``int8kv_split_ranges`` and
``int8kv_split_ref`` (the same for the int8 kernel's key ranges),
``prefill_split_ranges`` and ``paged_prefill_tiles_ref`` (the tensor-core
prefill kernel's key ranges and its tile loop over pages, splits and
combine, P rounded to bf16), ``flash_tiles_ref`` (the tensor-core flash
kernel's tile loop, with P rounded to bf16 for the PV product; both loops
walk keys in the kernels' tiles, ``tc_key_tile``),
``ssd_tiles_ref`` (the tensor-core SSD scan's CB, chunk states, state
passing and row tiles, M and w x rounded to bf16, with its broken
variants), ``rmsnorm_one_pass_ref`` (the one-pass RMSNorm kernel's
layout of a row over threads and warps, with its broken variants) and
``rounding_bound_ratio`` (the element-wise check derived from the
rounding).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1.0e30


def tc_key_tile(D: int) -> int:
    """Keys per tile of the tensor-core flash and prefill kernels at head
    dim ``D`` (``csrc/tc_attention.cuh``'s ``key_tile``): 64 up to D =
    160, 32 at gemma2-2b's 288, where a thread's 144 f32 of O leave no
    registers for a 64-key S."""
    return 32 if D > 160 else 64


def _gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(NP, page, KV, D) pages through (B, pps) tables -> (B, T, KV, D)."""
    NP, page, KV, D = pages.shape
    B, pps = tables.shape
    idx = tables.to(torch.long).clamp(0, NP - 1).reshape(-1)
    return pages[idx].reshape(B, pps * page, KV, D)


def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, return_lse: bool = False):
    """q: (BH, Sq, D); k, v: (BH, Skv, D).  Naive softmax attention with
    top-left causal (``kpos <= qpos``), sliding-window
    (``qpos - kpos < window``) and logit-softcap (``c * tanh(s / c)``,
    before the mask) options.  Returns out (BH, Sq, D) in q's dtype and,
    with ``return_lse``, also the per-row logsumexp of the masked scores
    (BH, Sq) f32, ``-inf`` for a row with no valid key."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=1)[None]                    # (1, Sq)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    out = torch.where(any_valid[..., None], out,
                      torch.zeros_like(out)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, torch.where(any_valid, lse, torch.full_like(lse, -math.inf))


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


def paged_split_ranges(length: int, pages_per_split: int, splits: int,
                       page: int, pps: int, window: Optional[int] = None):
    """The pages ``[lo, hi]`` each split of a decode row reads, or None
    where its block writes a neutral partial: split ``s`` covers pages
    ``[s * pages_per_split, (s + 1) * pages_per_split)`` clipped to the
    row's reachable pages, from the window's first page to
    ``(length - 1) // page`` (and ``pps - 1``).  The CUDA split kernel
    clips the same way."""
    q_pos = length - 1
    first = max(0, q_pos - (window - 1)) // page if window else 0
    last = min((length - 1) // page, pps - 1) if length > 0 else -1
    out = []
    for s in range(splits):
        lo = max(s * pages_per_split, first)
        hi = min(s * pages_per_split + pages_per_split - 1, last)
        out.append((lo, hi) if lo <= hi else None)
    return out


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              pages_per_split: int,
                              scale: Optional[float] = None,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None, keep=None,
                              return_partials: bool = False):
    """``paged_attention_ref`` computed as the split kernel does, in f32:
    the table cut into ``ceil(pps / pages_per_split)`` ranges of
    ``pages_per_split`` pages, a partial
    ``(m, l, acc)`` per range (``m = -1e30, l = 0`` where the range holds
    no valid key: a neutral partial), then the combine
    ``sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m) l_i`` over the partials
    with ``l_i > 0``.  ``keep``: an optional (B, n_splits) bool mask of
    partials the combine takes (a broken combine, for the checks' power).
    Returns out (B, KV, G, D) in q's dtype, and with ``return_partials``
    also (m, l), each (B, KV, n_splits, G)."""
    B, KV, G, D = q.shape
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    per = pages_per_split
    n = -(-pps // per)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    T = n * per * page
    pad = T - pps * page
    k = torch.nn.functional.pad(_gather(k_pages, block_tables).float(),
                                (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(_gather(v_pages, block_tables).float(),
                                (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) * scale
    s = _softcap(s, softcap)
    kpos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.to(torch.long).to(q.device)[:, None]
    mask = (kpos < lens) & (kpos < pps * page)
    if window is not None:
        mask &= (lens - 1) - kpos < window
    mask = mask[:, None, None, :].expand(B, KV, G, T).reshape(
        B, KV, G, n, per * page)
    s = torch.where(mask, s.reshape(mask.shape), torch.full_like(
        mask, NEG_INF, dtype=torch.float32))
    m = s.amax(dim=-1)                                   # (B, KV, G, n)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p,
                       v.reshape(B, n, per * page, KV, D))
    use = l > 0
    if keep is not None:
        use &= keep.to(q.device)[:, None, None, :]
    out = _combine(m, l, acc, use).to(q.dtype)
    if not return_partials:
        return out
    return out, (m.permute(0, 1, 3, 2), l.permute(0, 1, 3, 2))


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


def flash_tiles_ref(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    block_k: Optional[int] = None,
                    p_dtype: torch.dtype = torch.bfloat16,
                    rescale_l: bool = True):
    """The tensor-core flash kernel's loop, in PyTorch, at the model layout
    (q (B, Sq, H, D), k/v (B, Skv, KV, D)): kv tiles of ``block_k`` keys
    (None: the kernel's, ``tc_key_tile(D)``),
    S = Q K^T in f32, the online softmax in f32 (running max m, sum l of
    the unrounded P, accumulator rescaled by exp(m_old - m_new)), and P
    rounded to ``p_dtype`` before the PV product.  ``rescale_l=False`` is a
    broken kernel that forgets to rescale l.  Returns (out in q's dtype,
    lse (B, H, Sq) f32, -inf for a row with no valid key)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    block_k = block_k or tc_key_tile(D)
    dev = q.device
    qf = q.float().reshape(B, Sq, KV, G, D)
    qpos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, KV, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, KV, G, Sq, D), device=dev)
    for k0 in range(0, Skv, block_k):
        kt = k[:, k0:k0 + block_k].float()
        vt = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, kt) * scale
        s = _softcap(s, softcap)
        kpos = torch.arange(k0, k0 + kt.shape[1], device=dev)[None, :]
        mask = torch.ones((Sq, kt.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where((m_new == NEG_INF)[..., None], torch.zeros_like(s),
                        torch.exp(s - m_new[..., None]))
        l = (alpha * l if rescale_l else l) + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(p_dtype).float(), vt)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None],
                      torch.zeros_like(acc))
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)),
                      torch.full_like(l, -math.inf))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    return out, lse.reshape(B, H, Sq)


def rounding_bound_ratio(got, plain, mix_abs, p_rel: float) -> float:
    """max over elements of ``|got - plain| / bound``, with
    ``bound = p_rel * mix_abs + ulp_rel * |plain| + 2^-30``: ``mix_abs`` is
    (|P| @ |V|) / l, the same attention over |V| in f32 (the most a
    relative error ``p_rel`` in each P can move an output), and
    ``ulp_rel * |plain|`` one ulp of the output's dtype (2^-7 for bf16,
    2^-23 for f32) for its final rounding.  A reading above 1 fails."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    r = plain.float()
    bound = p_rel * mix_abs.float() + ulp * r.abs() + 2.0 ** -30
    return ((got.float() - r).abs() / bound).max().item()


def dequantize_kv(k8, k_scale, v8, v_scale, dtype):
    """Per-token int8 codes (B, S, KV, D) times their scales (B, S, KV).

    K comes out rounded to ``dtype`` (the compute dtype: q's), V in f32
    unrounded.  That is what the reference's jitted int8 decode reads: it
    writes ``k8.astype(dt) * k_scale.astype(dt)`` for both, but XLA
    folds V's bf16 rounding into the f32 convert of the P.V product while
    K's rounded product feeds the score dot.  With f32 q both are the
    TPU kernel's f32 products."""
    k = (k8.float() * k_scale.float()[..., None]).to(dtype).float()
    v = v8.float() * v_scale.float()[..., None]
    return k, v


def attention_int8kv_ref(q, k8, k_scale, v8, v_scale, q_start, kv_len, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Attention over an int8 K/V cache with per-row query positions.

    q: (B, Sq, H, D) f32 or bf16; k8, v8: (B, Skv, KV, D) int8; k_scale,
    v_scale: (B, Skv, KV), H = G * KV (GQA: head h reads kv head
    h // G).  Query i of row b sits at position ``q_start[b] + i``; keys
    at or past ``kv_len[b]`` (or ``Skv``) are masked, as are keys past the
    query (``causal``) and keys ``window`` or more behind it.  K/V are
    dequantized as in ``dequantize_kv``; softmax attention in f32.  Rows
    with no valid key return zeros.  Returns (B, Sq, H, D) in q's dtype.
    With ``q_start = 0`` and ``kv_len = Skv`` this is the function of the
    TPU kernel ``flash_attention_int8kv`` (per folded head).
    ``return_lse``: also the log-sum-exp of each row's masked scores,
    (B, Sq, H) f32, -inf for a row with no valid key."""
    B, Sq, H, D = q.shape
    Skv, KV = k8.shape[1], k8.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    k, v = dequantize_kv(k8, k_scale, v8, v_scale, q.dtype)
    qf = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k) * scale
    s = _softcap(s, softcap)
    qpos = (q_start.to(dev, torch.long)[:, None]
            + torch.arange(Sq, device=dev)[None, :])[:, :, None]   # (B,Sq,1)
    kpos = torch.arange(Skv, device=dev)[None, None, :]
    mask = (kpos < kv_len.to(dev, torch.long)[:, None, None]).expand(
        B, Sq, Skv)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v)
    any_valid = mask.any(dim=2)[:, :, None, None, None]
    out = torch.where(any_valid, out, torch.zeros_like(out))
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(dim=2)[:, None, None, :],
                      torch.logsumexp(s, dim=-1), float("-inf"))
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def int8kv_split_ranges(q_start: int, kv_len: int, Skv: int, G: int,
                        keys_per_split: int, splits: int, *, row0: int,
                        rows: int, causal: bool = True,
                        window: Optional[int] = None):
    """The keys ``[lo, hi)`` each split's block of one row tile (folded
    rows ``[row0, row0 + rows)``, row ``i * G + g`` at position
    ``q_start + i``) reads, or None where it writes a neutral partial: split
    ``s`` covers keys ``[s * keys_per_split, (s + 1) * keys_per_split)``
    clipped to the keys the tile's rows can see, from the window's first
    key of its oldest row to ``min(kv_len, Skv)`` and, causal, its newest
    row's position.  The CUDA split kernel clips the same way."""
    qpos_lo = q_start + row0 // G
    qpos_hi = q_start + (row0 + rows - 1) // G
    hi = min(kv_len, Skv)
    if causal:
        hi = min(hi, qpos_hi + 1)
    lo = max(0, qpos_lo - (window - 1)) if window else 0
    out = []
    for s in range(splits):
        a = max(lo, s * keys_per_split)
        b = min(hi, (s + 1) * keys_per_split)
        out.append((a, b) if a < b else None)
    return out


def _combine(m, l, acc, use):
    """Merge split partials (m, l (..., n), acc (..., n, D)) over the ones
    ``use`` selects: sum exp(m_i - m) acc_i / sum exp(m_i - m) l_i, zeros
    where none is selected."""
    m_all = torch.where(use, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    w = torch.where(use, torch.exp(m - m_all[..., None]), torch.zeros_like(m))
    den = (w * l).sum(dim=-1)
    num = (w[..., None] * acc).sum(dim=-2)
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None],
                       torch.zeros_like(num))


def int8kv_split_ref(q, k8, k_scale, v8, v_scale, q_start, kv_len, *,
                     keys_per_split: int, causal: bool = True,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None, keep=None):
    """``attention_int8kv_ref`` computed as the split kernel does, in f32:
    the key axis cut into ``ceil(Skv / keys_per_split)`` ranges, a partial
    ``(m, l, acc)`` per range and folded row (neutral where the range holds
    no valid key for the row), then the combine over the partials with
    ``l > 0``.  ``keep``: an optional (B, n_splits) bool mask of partials
    the combine takes (a broken combine, for the checks' power).  Returns
    (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k8.shape[1], k8.shape[2]
    G = H // KV
    per = keys_per_split
    n = -(-Skv // per)
    T = n * per
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    k, v = dequantize_kv(k8, k_scale, v8, v_scale, q.dtype)
    pad = (0, 0, 0, 0, 0, T - Skv)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    qf = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k) * scale
    s = _softcap(s, softcap)
    qpos = (q_start.to(dev, torch.long)[:, None]
            + torch.arange(Sq, device=dev)[None, :])[:, :, None]
    kpos = torch.arange(T, device=dev)[None, None, :]
    mask = (kpos < kv_len.to(dev, torch.long)[:, None, None]) & (kpos < Skv)
    mask = mask.expand(B, Sq, T)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    mask = mask[:, None, None].expand(B, KV, G, Sq, T).reshape(
        B, KV, G, Sq, n, per)
    s = torch.where(mask, s.reshape(mask.shape),
                    torch.full(mask.shape, NEG_INF, device=dev))
    m = s.amax(dim=-1)                                   # (B, KV, G, Sq, n)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqnt,bntkd->bkgqnd", p, v.reshape(B, n, per, KV, D))
    use = l > 0
    if keep is not None:
        use = use & keep.to(dev)[:, None, None, None, :]
    out = _combine(m, l, acc, use)                       # (B, KV, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def prefill_split_ranges(start: int, q_len: int, T: int, G: int,
                         keys_per_split: int, splits: int, *, row0: int,
                         rows: int, window: Optional[int] = None):
    """The keys ``[lo, hi)`` each split's block of one prefill row tile
    (folded rows ``[row0, row0 + rows)``, row ``c * G + g`` at position
    ``start + c``) reads, or None where it writes neutral partials: split
    ``s`` covers keys ``[s * keys_per_split, (s + 1) * keys_per_split)``
    clipped to what the tile's valid queries (c < q_len) can see, from the
    oldest one's window start to the newest one's position and the table's
    ``T`` positions.  The CUDA split kernel clips the same way."""
    c_lo = row0 // G
    c_hi = min((row0 + rows - 1) // G, q_len - 1)
    out = []
    for s in range(splits):
        r = None
        if c_lo <= c_hi:
            lo = max(0, start + c_lo - (window - 1)) if window else 0
            a = max(lo, s * keys_per_split)
            b = min(start + c_hi + 1, T, (s + 1) * keys_per_split)
            r = (a, b) if a < b else None
        out.append(r)
    return out


def paged_prefill_tiles_ref(q, k_pages, v_pages, block_tables, start_pos,
                            q_lens, *, group: int, keys_per_split: int,
                            scale: Optional[float] = None,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            p_dtype: torch.dtype = torch.bfloat16,
                            keep=None):
    """The tensor-core prefill kernel's loop, in PyTorch, at the kernel's
    layout (q (B, KV, C*G, D), row ``c * G + g``): the table's ``pps *
    page`` keys cut into splits of ``keys_per_split`` (a multiple of 64),
    each walked in the kernel's tiles of ``tc_key_tile(D)`` keys with
    S = Q K^T in f32, the online softmax in
    f32 (running max m, sum l of the unrounded P, accumulator rescaled by
    exp(m_old - m_new)) and P rounded to ``p_dtype`` for the PV product; a
    partial per split and row, then the combine over the partials with
    ``l > 0``.  ``keep``: an optional (B, n_splits) bool mask of partials
    the combine takes (a broken combine, for the checks' power).  Padding
    rows (c >= q_len) are zeros.  Returns (B, KV, C*G, D) in q's dtype."""
    B, KV, CG, D = q.shape
    G = group
    C = CG // G
    page, pps = k_pages.shape[1], block_tables.shape[1]
    T = pps * page
    per = keys_per_split
    n = -(-T // per)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bk = tc_key_tile(D)
    dev = q.device
    pad = (0, 0, 0, 0, 0, n * per - T)
    k = torch.nn.functional.pad(_gather(k_pages, block_tables).float(), pad)
    v = torch.nn.functional.pad(_gather(v_pages, block_tables).float(), pad)
    qf = q.float().reshape(B, KV, C, G, D)
    cidx = torch.arange(C, device=dev)
    qpos = start_pos.to(dev, torch.long)[:, None] + cidx[None, :]   # (B, C)
    valid = cidx[None, :] < q_lens.to(dev, torch.long)[:, None]
    m = torch.full((B, KV, C, G, n), NEG_INF, device=dev)
    l = torch.zeros((B, KV, C, G, n), device=dev)
    acc = torch.zeros((B, KV, C, G, n, D), device=dev)
    for k0 in range(0, n * per, bk):
        j = k0 // per                                    # the tile's split
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = torch.einsum("bkcgd,btkd->bkcgt", qf, kt) * scale
        s = _softcap(s, softcap)
        kpos = torch.arange(k0, k0 + bk, device=dev)[None, None, :]
        mask = (kpos <= qpos[:, :, None]) & (kpos < T) & valid[:, :, None]
        if window is not None:
            mask &= (qpos[:, :, None] - kpos) < window
        s = torch.where(mask[:, None, :, None], s, torch.full_like(s, NEG_INF))
        m_old = m[..., j]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.where((m_new == NEG_INF)[..., None], torch.zeros_like(s),
                        torch.exp(s - m_new[..., None]))
        l[..., j] = alpha * l[..., j] + p.sum(dim=-1)
        acc[..., j, :] = alpha[..., None] * acc[..., j, :] + torch.einsum(
            "bkcgt,btkd->bkcgd", p.to(p_dtype).float(), vt)
        m[..., j] = m_new
    use = l > 0
    if keep is not None:
        use = use & keep.to(dev)[:, None, None, None, :]
    out = _combine(m, l, acc, use)                       # (B, KV, C, G, D)
    return out.reshape(B, KV, CG, D).to(q.dtype)


def pad_to_chunks(x, dt, B, C, L: int):
    """Pad the sequence axis (1) of the SSD inputs to a multiple of ``L``
    with zeros: dt = 0 is inert (decay exp(0) = 1, no input)."""
    pad = (-x.shape[1]) % L
    if not pad:
        return x, dt, B, C
    F = torch.nn.functional
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad)))


def ssd_scan_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan, the reference's ``ssm.ssd_chunked``.

    x: (b, S, H, P); dt: (b, S, H) positive step sizes; A: (H,) negative
    decay rates; B, C: (b, S, G, N), head h reads group h // (H / G).
    initial_state: (b, H, N, P) or None (zeros).  Returns (y (b, S, H, P)
    in x's dtype, final_state (b, H, N, P) f32).  S is padded to a chunk
    multiple with dt = 0 (decay exp(0) = 1, no input), which leaves the
    state and the outputs unchanged.

    The intra-chunk decay exp(cum_i - cum_j) is taken only where j <= i:
    above the diagonal it overflows to inf once |dt * A| sums past ~88
    inside a chunk, and autograd through ``where(mask, inf, 0)`` gives
    0 * inf = NaN.  The selected values are the reference's.
    """
    S_orig = x.shape[1]
    L = min(chunk, S_orig)
    x, dt, B, C = pad_to_chunks(x, dt, B, C, L)
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // L
    rep = H // G
    xc = x.float().reshape(b, nc, L, H, P)
    dc = dt.float().reshape(b, nc, L, H)
    Bc = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, L, H, N)
    Cc = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, L, H, N)

    cum = torch.cumsum(dc * A.float()[None, None, None, :], dim=2)
    seg_total = cum[:, :, -1:, :]                           # (b, nc, 1, H)

    # intra-chunk: M[i, j] = C_i . B_j * exp(cum_i - cum_j) * dt_j, j <= i
    scores = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)
    cum_t = cum.permute(0, 1, 3, 2)                         # (b, nc, H, L)
    diff = cum_t[..., :, None] - cum_t[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    zero = torch.zeros((), dtype=diff.dtype, device=x.device)
    gates = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
    M = scores * gates * dc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", M, xc)

    # chunk states: sum_j exp(seg_total - cum_j) * dt_j * B_j x_j^T
    w = torch.exp(seg_total - cum) * dc
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", w, Bc, xc)

    # inter-chunk recurrence, sequential over the nc chunks
    seg_decay = torch.exp(seg_total[:, :, 0, :])            # (b, nc, H)
    h = (torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = seg_decay[:, c, :, None, None] * h + states[:, c]
    h_enter = torch.stack(h_enter, dim=1)                   # (b, nc, H, N, P)

    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           Cc * torch.exp(cum)[..., None], h_enter)
    y = (y_intra + y_inter).reshape(b, S, H, P)[:, :S_orig]
    return y.to(x.dtype), h


SSD_WRONGS = ("mask one row late", "h_enter one chunk late",
              "no chunk decay exp(seg)", "group h % G")


def ssd_tiles_ref(x, dt, A, B, C, chunk: int, *,
                  wrong: Optional[str] = None):
    """The tensor-core SSD scan's decomposition, in PyTorch at the model
    layout (x (b, S, H, P), B and C (b, S, G, N), S a multiple of
    ``L = min(chunk, S)``), with its rounding points:

    (a) CB = C . B^T per (b, chunk, group) in f32 (products of bf16 values
        are exact);
    (b) per head cum, w = exp(seg - cum) dt and the chunk state
        B^T (w x), w x entering as a hi + lo pair in x's dtype;
    (c) the state passing h_enter[c + 1] = exp(seg_c) h_enter[c] + state_c
        in f32;
    (d) per 64-row tile, exp(cum_i) (C_i . h_enter) with h_enter as a hi +
        lo pair, plus M . x over the column tiles at or below the diagonal,
        M = CB exp(cum_i - cum_j) dt_j selected before the exp, as a hi +
        lo pair.

    ``wrong`` (one of ``SSD_WRONGS``) is a broken kernel, for the checks'
    power: the mask one row late (j <= i + 1), h_enter one chunk late, the
    state's decay exp(seg) left out, or head h reading group h % G instead
    of h // (H / G).  Returns y (b, S, H, P) in x's dtype."""
    if wrong is not None and wrong not in SSD_WRONGS:
        raise ValueError(f"unknown broken scan {wrong!r}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    L = min(chunk, S)
    nc = S // L
    dev = x.device

    def pair(t):                     # hi + lo, each rounded to x's dtype
        hi = t.to(x.dtype).float()
        return hi + (t - hi).to(x.dtype).float()

    heads = torch.arange(H, device=dev)
    grp = heads % G if wrong == "group h % G" else heads // (H // G)
    xc = x.float().reshape(b, nc, L, H, P)
    dc = dt.float().reshape(b, nc, L, H)
    Bc = B.float().reshape(b, nc, L, G, N)
    Cc = C.float().reshape(b, nc, L, G, N)
    # (a) per group
    cb = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)[:, :, grp]  # (b,nc,H,L,L)
    # (b) per head
    cum = torch.cumsum(dc * A.float()[None, None, None, :], dim=2)
    seg = cum[:, :, -1:, :]
    w = torch.exp(seg - cum) * dc
    states = torch.einsum("bclhn,bclhp->bchnp", Bc[:, :, :, grp],
                          pair(w[..., None] * xc))
    # (c) in f32
    decay = torch.exp(seg[:, :, 0, :])
    h = torch.zeros((b, H, N, P), device=dev)
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = (h if wrong == "no chunk decay exp(seg)"
             else decay[:, c, :, None, None] * h) + states[:, c]
    if wrong == "h_enter one chunk late":
        h_enter = [torch.zeros_like(h)] + h_enter[:-1]
    h_enter = torch.stack(h_enter, dim=1)                 # (b, nc, H, N, P)
    h_near = pair(h_enter)
    # (d) per row tile
    Ch = Cc[:, :, :, grp]                                 # (b, nc, L, H, N)
    cum_t = cum.permute(0, 1, 3, 2)                       # (b, nc, H, L)
    dt_t = dc.permute(0, 1, 3, 2)
    late = 1 if wrong == "mask one row late" else 0
    tile = 64                                             # the kernel's
    y = torch.zeros((b, nc, L, H, P), device=dev)
    for i0 in range(0, L, tile):
        rows = slice(i0, i0 + tile)
        acc = torch.einsum("bclhn,bchnp->bclhp", Ch[:, :, rows], h_near)
        acc = acc * torch.exp(cum[:, :, rows])[..., None]
        ii = torch.arange(i0, min(i0 + tile, L), device=dev)[:, None]
        for j0 in range(0, min(i0 + tile + late, L), tile):
            cols = slice(j0, j0 + tile)
            jj = torch.arange(j0, min(j0 + tile, L), device=dev)[None, :]
            mask = jj <= ii + late
            diff = cum_t[..., rows, None] - cum_t[..., None, cols]
            zero = torch.zeros((), device=dev)
            M = torch.where(mask, cb[..., rows, cols] * torch.exp(
                torch.where(mask, diff, zero)) * dt_t[..., None, cols], zero)
            acc = acc + torch.einsum("bchlm,bcmhp->bclhp", pair(M),
                                     xc[:, :, cols])
        y[:, :, rows] = acc
    return y.reshape(b, S, H, P).to(x.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6, out_dtype=None):
    """x (..., d); scale (d,).  x * rsqrt(mean(x^2) + eps) * (1 + scale),
    in f32; the result in ``out_dtype`` (default: x's dtype)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(out_dtype or x.dtype)


RMSNORM_WRONGS = ("one warp's partial left out", "gain read as scale",
                  "last pack not written")


def rmsnorm_one_pass_ref(x, scale, eps: float = 1e-6, out_dtype=None, *,
                         plan, wrong: Optional[str] = None):
    """``rmsnorm_ref`` as the one-pass kernel lays a row out: ``plan`` =
    (packs a thread, threads a row, rows a block) from
    ``rmsnorm.one_pass_plan``; thread t of a row holds packs t, t + TPR, ...
    of 8 elements, warp w the threads [32 w, 32 w + 32).  ``wrong`` (one of
    ``RMSNORM_WRONGS``) is a broken kernel, for the check's power: the
    row's last warp's partial sum left out, the gain read as ``scale``
    instead of ``1 + scale``, or the row's last pack of 8 not written (left
    zero)."""
    if wrong is not None and wrong not in RMSNORM_WRONGS:
        raise ValueError(f"unknown broken kernel {wrong!r}")
    ppt, tpr, _ = plan
    d = x.shape[-1]
    xf = x.float()
    sq = xf.square()
    if wrong == "one warp's partial left out":
        pack = torch.arange(d, device=x.device) // 8
        last_warp = (pack % tpr) // 32 == tpr // 32 - 1
        sq = torch.where(last_warp, torch.zeros_like(sq), sq)
    y = xf * torch.rsqrt(sq.sum(dim=-1, keepdim=True) / d + eps)
    gain = scale.float() if wrong == "gain read as scale" else (
        1.0 + scale.float())
    y = y * gain
    if wrong == "last pack not written":
        y[..., d - 8:] = 0.0             # the one-pass kernel's d % 8 == 0
    return y.to(out_dtype or x.dtype)
