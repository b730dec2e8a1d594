"""Paged single-token decode attention: CUDA kernel + plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention.paged_attention``.  The
kernel (``csrc/paged_attention.cu``) splits every row's context: a grid of
``(splits, KV, B)`` blocks, each over a contiguous range of
``pages_per_split`` pages clipped to the row's reachable pages, shares each
K/V page read by all G query heads of the group and writes a partial
``(m, l, acc)`` in f32; a second kernel of the same call merges the
partials.  :func:`split_plan` picks the split from shapes only (never
``lengths``: reading them would sync the host with the device on the
decode path).  See the source's header for its bound and design.

``paged_attention`` dispatches on the device of ``q``: a CPU tensor goes
through the plain version (``repro_torch.kernels.ref``), a CUDA tensor
launches the kernels or raises, a ``meta`` tensor allocates the output and
the split's partials and adds :func:`cost` to ``_build.meta_cost``.  The kernels take q and the pages in bf16
or in f32 (one dtype for all three; the source is instantiated on each,
and a split holds half the pages in f32); the output is in q's dtype.
``paged_attention.launches`` counts wrapper calls that launched (each
issues two CUDA kernels: split and combine); ``DTYPE_LAUNCHES[dtype]``
counts each instantiation's, registered as ``decode_bf16`` and
``decode_f32``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_fns = {}
SM_COUNT = 132                  # H100 (and H200) SXM streaming multiprocessors:
                                # the split plans' default, for the CPU tests
BLOCKS_PER_SM = 4               # the split aims at this many blocks per SM
KV_SMEM_BYTES = 48 * 1024       # a split's K and V in shared memory, at most
P_ROUNDING = 2.0 ** -14         # the kernel keeps P in f32: the element-wise
                                # check's relative term, 2^10 f32 roundings
                                # (2^-24 each) of headroom for sums taken in
                                # another order


KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
DTYPE_LAUNCHES = {dtype: _build.counter(f"decode_{name}")
                  for dtype, name in KERNEL_DTYPES.items()}


def _entry(dtype: torch.dtype):
    """The C entry for q's ``dtype``: ``paged_decode_bf16`` or ``_f32``."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load("paged_attention"),
                     f"paged_decode_{KERNEL_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


_sm_counts = {}


def device_sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA ``device``, read once per
    device (the split plans size their grids by it)."""
    if torch.device(device).type != "cuda":
        return SM_COUNT                   # the meta route's plan
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def cost(q_shape, pps: int, *, lengths=None, page: int = 0,
         window: Optional[int] = None, itemsize: int = 2):
    """(bytes, flops) a decode call needs (``q_shape`` (B, KV, G, D),
    ``pps`` pages a row's table): q read and the output written once, the
    K and V positions each row attends (window included) read once, the
    lengths and tables; 4 flops per (query head, position, dim).
    ``lengths``: each row's valid positions; None counts every row at its
    table's full extent, ``pps * page`` (the most the shapes can need:
    the ``meta`` route's count)."""
    B, KV, G, D = q_shape
    if lengths is None:
        lengths = [pps * page] * B
    pos = sum(min(n, window) if window else n for n in lengths)
    q_bytes = B * KV * G * D * itemsize
    nbytes = 2 * q_bytes + pos * KV * D * itemsize * 2 + B * 4 * (1 + pps)
    return nbytes, 4 * pos * KV * G * D


def split_plan(B: int, KV: int, pps: int, page: int, D: int,
               sm_count: int = SM_COUNT, elem_bytes: int = 2):
    """``(pages_per_split, splits)`` for a decode call, from shapes only.

    Enough splits that ``B * KV * splits`` covers the ``sm_count`` SMs
    about ``BLOCKS_PER_SM`` times over, each split at most ``KV_SMEM_BYTES`` of
    K and V (``2 * elem_bytes * page * D`` bytes a page: bf16 2, f32 4) and
    at least one page; ``splits * pages_per_split >= pps`` covers the whole
    table.  Which of a row's pages a split reads is
    :func:`ref.paged_split_ranges`."""
    cap = max(1, KV_SMEM_BYTES // (2 * elem_bytes * page * D))
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * KV))
    per = max(1, min(cap, -(-pps // want)))
    return per, -(-pps // per)


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """The plain PyTorch version at the kernel's layout (any device)."""
    return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=scale, window=window, softcap=softcap)


def _check_cuda(q, k_pages, v_pages, block_tables, **rows):
    """What the CUDA kernels take: everything on q's device and
    contiguous; q and pages of one dtype, bf16 or f32; int32 tables and
    per-row ``rows`` vectors of shape (B,); pages (NP, page, KV, D)
    matching q's KV and D (q is (B, KV, rows, D)); D <= 288 and page <=
    32."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernels take bfloat16 or float32, got {q.dtype}")
    dev = q.device
    B, KV, _, D = q.shape
    ints = {"block_tables": block_tables, **rows}
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    *ints.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = q.dtype if name in ("q", "k_pages", "v_pages") \
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


@_build.counted
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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check_cuda(q, k_pages, v_pages, block_tables, lengths=lengths)
    B, KV, G, D = q.shape
    # the split kernel copies K/V rows in 16-byte pieces
    if D % 8:
        raise ValueError(f"decode kernel takes D a multiple of 8, got D={D}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    _launch(q, k_pages, v_pages, block_tables, lengths, out, scale, window,
            softcap)
    if q.device.type == "meta":
        _build.meta_cost.add("paged_attention", *cost(
            q.shape, block_tables.shape[1], page=k_pages.shape[1],
            window=window, itemsize=q.element_size()))
        return out
    paged_attention.launches += 1
    return out


def _launch(q, k_pages, v_pages, block_tables, lengths, out, scale, window,
            softcap):
    """The split kernel and its combine, into ``out``, through the C entry
    of q's dtype."""
    B, KV, G, D = q.shape
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    per, splits = split_plan(B, KV, pps, page, D, device_sm_count(q.device),
                             q.element_size())
    part_ml = torch.empty((B, KV, splits, G, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, KV, splits, G, D), dtype=torch.float32,
                           device=q.device)
    if q.device.type == "meta":
        return
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                    B, KV, G, D, NP, page, pps, per, splits, float(scale),
                    int(window or 0), float(softcap or 0.0), stream)
    _build.check(status, f"paged_attention ({KERNEL_DTYPES[q.dtype]})")
    DTYPE_LAUNCHES[q.dtype].launches += 1
