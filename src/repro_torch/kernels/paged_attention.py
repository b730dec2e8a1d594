"""Paged single-token decode attention: CUDA kernel + plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention.paged_attention``.  The
kernel (``csrc/paged_attention.cu``) runs one thread block per
``(b, kv_head)``, walks only the row's reachable pages through the block
table with an online softmax in f32, and shares each K/V page read by all
G query heads of the group.  See the source's header for its bound and
design.

``paged_attention`` dispatches on the device of ``q``: a CPU tensor goes
through the plain version (``repro_torch.kernels.ref``), a CUDA tensor
launches the kernel or raises.  ``paged_attention.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").paged_decode_bf16
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """The plain PyTorch version at the kernel's layout (any device)."""
    return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=scale, window=window, softcap=softcap)


def _check_cuda(q, k_pages, v_pages, block_tables, **rows):
    """What the CUDA kernels take: everything on q's device and
    contiguous; bf16 q and pages; int32 tables and per-row ``rows``
    vectors of shape (B,); pages (NP, page, KV, D) matching q's KV and D
    (q is (B, KV, rows, D)); D <= 288 and page <= 32."""
    dev = q.device
    B, KV, _, D = q.shape
    ints = {"block_tables": block_tables, **rows}
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    *ints.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.bfloat16 if name in ("q", "k_pages", "v_pages") \
            else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[2:]) != (KV, D):
        raise ValueError(f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)}, B={B}")
    for name, t in rows.items():
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} {tuple(t.shape)}, B={B}")
    if D > 288 or k_pages.shape[1] > 32:
        raise ValueError(f"kernel takes D <= 288 and page <= 32, got "
                         f"D={D}, page={k_pages.shape[1]}")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Paged single-token decode attention.

    q: (B, KV, G, D) — one query token per sequence, grouped GQA layout;
    k_pages, v_pages: (NP, page, KV, D) block storage;
    block_tables: (B, pps) int32 — page ids backing positions
      ``[j*page, (j+1)*page)`` (entries past the extent are clamped and
      masked);
    lengths: (B,) int32 — valid positions including the current token.
    Returns (B, KV, G, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check_cuda(q, k_pages, v_pages, block_tables, lengths=lengths)
    B, KV, G, D = q.shape
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), B, KV, G, D, NP, page, pps, float(scale),
                    int(window or 0), float(softcap or 0.0), stream)
    _build.check(status, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
