"""Paged chunked-prefill attention: CUDA kernels + plain PyTorch version.

Counterpart of ``repro.kernels.paged_prefill.paged_prefill``.  The query
chunk is folded to ``CG = chunk * group`` rows per KV head (row ``c*G+g``),
so all G heads of a group share every page read.  ``csrc/paged_prefill.cu``
holds two kernels, chosen by :func:`tensor_core_route` (dtype and head dim,
never a failed build or launch):

- bf16 with ``D`` in {32, 64, 96, 128, 288}: a tensor-core kernel
  (mma.sync, P rounded to bf16 for the PV product) split over the context:
  a grid of ``(splits x row tiles, KV, B)`` blocks, each over a range of
  ``keys_per_split`` keys from :func:`split_plan` (shapes only), walked in
  tiles of ``ref.tc_key_tile(D)`` keys (64; 32 at gemma2-2b's 288) staged
  through the block table, writing a partial ``(m, l, acc)`` per row; a
  second kernel of the same call merges them;
- f32 (any head dim), and bf16 with other head dims: a CUDA-core kernel,
  one block per ``(b, kv_head, 16 rows)``, walking the row's pages with P
  in f32, instantiated on the element type (its C entries
  ``paged_prefill_bf16`` and ``paged_prefill_f32``).

See the source's header for their bound and design.

``paged_prefill`` dispatches on the device of ``q``: a CPU tensor goes
through the plain version (``repro_torch.kernels.ref``), a CUDA tensor
launches a kernel or raises, a ``meta`` tensor allocates the output (and
the tensor-core route's partials) and adds :func:`cost` to
``_build.meta_cost``.  ``paged_prefill.launches`` counts every
launch; ``prefill_tensor_core.launches`` and ``prefill_cuda_core.launches``
count each kernel's.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (BLOCKS_PER_SM,
                                                 KERNEL_DTYPES, SM_COUNT,
                                                 _check_cuda,
                                                 device_sm_count)
from repro_torch.kernels.ref import paged_prefill_ref, tc_key_tile

_fns = {}
_fn_tc = None
TILE_KEYS = 64                  # a split is a whole number of these keys
SMEM_PER_SM = 233_472           # an H100 SM's shared memory (228 KB)
SMEM_PER_BLOCK_RESERVED = 1024  # of which the runtime keeps per block


def _entry(dtype: torch.dtype):
    """The CUDA-core kernel's C entry for q's ``dtype``."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load("paged_prefill"),
                     f"paged_prefill_{KERNEL_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _entry_tc():
    global _fn_tc
    if _fn_tc is None:
        fn = _build.load("paged_prefill").paged_prefill_tc_bf16
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_tc = fn
    return _fn_tc


# the tensor-core prefill kernel's instantiations (csrc/paged_prefill.cu)
TENSOR_CORE_HEAD_DIMS = (32, 64, 96, 128, 288)


def tensor_core_route(dtype: torch.dtype, D: int) -> bool:
    """bf16 at a head dim the tensor-core prefill kernel is built for
    (``TENSOR_CORE_HEAD_DIMS``, gemma2-2b's 288 among them); f32 and
    every other ``D`` run the CUDA-core kernel."""
    return dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS


def p_rounding(dtype: torch.dtype, D: int) -> float:
    """The relative error of P in the PV product of the kernel that
    ``(dtype, D)`` routes to, the element-wise check's relative term:
    2^-8 where P is rounded to bf16 (2^-9, doubled for headroom), 2^-14
    where it stays f32 (2^10 f32 roundings of headroom for sums taken in
    another order)."""
    return 2.0 ** -8 if tensor_core_route(dtype, D) else 2.0 ** -14


def cost(q_shape, group: int, pps: int, *, starts=None, q_lens=None,
         page: int = 0, window: Optional[int] = None, itemsize: int = 2):
    """(bytes, flops) a prefill call needs (``q_shape`` (B, KV, C * G,
    D), ``pps`` pages a row's table): q read and the output written once,
    each row's reachable history read once; 4 flops per (query head,
    attended key, dim), causal and window masks counted.  ``starts`` /
    ``q_lens``: each row's first position and valid queries; None counts
    every row's C queries at the end of its table's extent (the most the
    shapes can need: the ``meta`` route's count)."""
    B, KV, CG, D = q_shape
    C = CG // group
    if starts is None:
        starts, q_lens = [max(0, pps * page - C)] * B, [C] * B
    w = window
    hist = attended = 0
    for s, ql in zip(starts, q_lens):
        if ql == 0:
            continue
        lo = max(0, s - w + 1) if w else 0
        hist += s + ql - lo                      # positions read
        for c in range(ql):
            p = s + c
            attended += p + 1 - (max(0, p - w + 1) if w else 0)
    q_bytes = B * KV * CG * D * itemsize
    nbytes = 2 * q_bytes + hist * KV * D * itemsize * 2 + B * 4 * (2 + pps)
    return nbytes, 4 * attended * KV * group * D


def row_tile(D: int) -> int:
    """Folded query rows a tensor-core block holds: 128 for ``D <= 64``
    (two 16-row tiles a warp), else 64."""
    return 128 if D <= 64 else 64


def tc_smem_bytes(D: int) -> int:
    """Shared memory of one tensor-core block (``tc_attention.cuh``'s
    ``smem_bytes``): the Q tile and two stages of K and V tiles, bf16 rows
    padded by 8."""
    return (row_tile(D) + 4 * tc_key_tile(D)) * (D + 8) * 2


def blocks_resident(D: int) -> int:
    """Tensor-core blocks one SM holds at once by shared memory, at most
    ``BLOCKS_PER_SM``: 4 at D = 64, 2 at D = 128 and at D = 288."""
    return max(1, min(BLOCKS_PER_SM, SMEM_PER_SM
                      // (tc_smem_bytes(D) + SMEM_PER_BLOCK_RESERVED)))


def split_plan(B: int, KV: int, pps: int, page: int, D: int, rows: int,
               sm_count: int = SM_COUNT):
    """``(keys_per_split, splits)`` for a tensor-core prefill call, from
    shapes only (never ``start_pos`` or ``q_lens``, which live on the
    card); ``rows`` is C * G, the folded rows per kv head.

    Enough splits that the grid, ``splits`` x row tiles (:func:`row_tile`)
    x ``KV`` x ``B`` blocks, fills every SM with as many blocks as its
    shared memory holds (:func:`blocks_resident`), each split a whole
    number of ``TILE_KEYS``; ``keys_per_split * splits >= pps * page``.
    Fewer splits where fewer blocks fit keep the partials, which the
    combine reads back, small.  Which keys a split's block reads is
    :func:`ref.prefill_split_ranges`."""
    tiles = -(-rows // row_tile(D))
    n_tiles = max(1, -(-pps * page // TILE_KEYS))
    want = -(-blocks_resident(D) * sm_count // max(1, B * KV * tiles))
    per = -(-n_tiles // want)
    return per * TILE_KEYS, -(-n_tiles // per)


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


@_build.counted
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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_prefill: no kernel for device {q.device}")
    _check_cuda(q, k_pages, v_pages, block_tables, start_pos=start_pos,
                q_lens=q_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    launch = (prefill_tensor_core if tensor_core_route(q.dtype, D)
              else prefill_cuda_core)
    launch(q, k_pages, v_pages, block_tables, start_pos, q_lens, out, group,
           scale, window, softcap)
    if q.device.type == "meta":
        _build.meta_cost.add("paged_prefill", *cost(
            q.shape, group, block_tables.shape[1], page=k_pages.shape[1],
            window=window, itemsize=q.element_size()))
        return out
    paged_prefill.launches += 1
    return out


@_build.counted
def prefill_tensor_core(q, k_pages, v_pages, block_tables, start_pos, q_lens,
                        out, group, scale, window, softcap):
    """Launch the tensor-core split kernel and its combine into ``out``."""
    B, KV, CG, D = q.shape
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    per, splits = split_plan(B, KV, pps, page, D, CG,
                             device_sm_count(q.device))
    part_ml = torch.empty((B, KV, splits, CG, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, KV, splits, CG, D), dtype=torch.float32,
                           device=q.device)
    if q.device.type == "meta":
        return
    fn = _entry_tc()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), start_pos.data_ptr(),
                    q_lens.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                    part_acc.data_ptr(), B, KV, CG, group, D, NP, page, pps,
                    per, splits, float(scale), int(window or 0),
                    float(softcap or 0.0), stream)
    _build.check(status, "paged_prefill (tensor cores)")
    prefill_tensor_core.launches += 1


@_build.counted
def prefill_cuda_core(q, k_pages, v_pages, block_tables, start_pos, q_lens,
                      out, group, scale, window, softcap):
    """Launch the CUDA-core kernel into ``out``."""
    B, KV, CG, D = q.shape
    NP, page = k_pages.shape[0], k_pages.shape[1]
    pps = block_tables.shape[1]
    if q.device.type == "meta":
        return
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), start_pos.data_ptr(),
                    q_lens.data_ptr(), out.data_ptr(), B, KV, CG, group, D,
                    NP, page, pps, float(scale), int(window or 0),
                    float(softcap or 0.0), stream)
    _build.check(status, "paged_prefill (CUDA cores)")
    prefill_cuda_core.launches += 1


