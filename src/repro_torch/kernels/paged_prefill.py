"""Paged chunked-prefill attention: CUDA kernel + plain PyTorch version.

Counterpart of ``repro.kernels.paged_prefill.paged_prefill``.  The query
chunk is folded to ``CG = chunk * group`` rows per KV head (row ``c*G+g``);
the kernel (``csrc/paged_prefill.cu``) runs one thread block per
``(b, kv_head, tile of query rows)``, walks the row's reachable pages
through the block table with an online softmax in f32, and masks causally
per query row.  See the source's header for its bound and design.

``paged_prefill`` dispatches on the device of ``q``: a CPU tensor goes
through the plain version (``repro_torch.kernels.ref``), a CUDA tensor
launches the kernel or raises.  ``paged_prefill.launches`` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import _check_cuda
from repro_torch.kernels.ref import paged_prefill_ref

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("paged_prefill").paged_prefill_bf16
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_prefill_plain(q, k_pages, v_pages, block_tables, start_pos,
                        q_lens, *, group: int,
                        scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The plain PyTorch version at the kernel's layout (any device)."""
    B, KV, CG, D = q.shape
    C = CG // group
    q5 = q.reshape(B, KV, C, group, D).permute(0, 2, 1, 3, 4)
    out = paged_prefill_ref(q5, k_pages, v_pages, block_tables, start_pos,
                            q_lens, scale=scale, window=window,
                            softcap=softcap)
    return out.permute(0, 2, 1, 3, 4).reshape(B, KV, CG, D)


def paged_prefill(q, k_pages, v_pages, block_tables, start_pos, q_lens, *,
                  group: int, scale: Optional[float] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """Paged chunked-prefill attention (grouped, chunk-folded layout).

    q: (B, KV, CG, D) — CG = chunk * group, row ``c*group + g`` is query
      token c of the chunk for head g of the KV group;
    k_pages, v_pages: (NP, page, KV, D) block storage with the chunk's own
      K/V already written at ``[start_pos[b], start_pos[b] + q_lens[b])``;
    block_tables: (B, pps) int32 (entries past the extent are clamped and
      masked); start_pos: (B,) int32 position of each row's first query;
    q_lens: (B,) int32 valid query tokens per row (0 = padding row).
    Returns (B, KV, CG, D) in q's dtype; padding query rows are zeros.
    """
    B, KV, CG, D = q.shape
    if CG % group != 0:
        raise ValueError(f"CG={CG} is not a multiple of group={group}")
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   start_pos, q_lens, group=group,
                                   scale=scale, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: no kernel for device {q.device}")
    _check_cuda(q, k_pages, v_pages, block_tables, start_pos=start_pos,
                q_lens=q_lens)
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), start_pos.data_ptr(),
                    q_lens.data_ptr(), out.data_ptr(), B, KV, CG, group, D,
                    NP, page, pps, float(scale), int(window or 0),
                    float(softcap or 0.0), stream)
    _build.check(status, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0
