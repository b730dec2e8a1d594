"""Dense flash attention: CUDA forward kernel, plain PyTorch version, and
the autograd Function whose backward is PyTorch.

Counterpart of ``repro.kernels.flash_attention.flash_attention``.  Both
kernels of ``csrc/flash_attention.cu`` run one thread block per
``(b * H + h, tile of 64 or 128 query rows)``, loop over the reachable K/V
tiles with an online softmax in f32, read each query head's kv head
``h // (H / KV)`` straight from the un-broadcast ``(B, S, KV, D)`` layout,
and also write the per-row logsumexp the backward needs.  See the source's header for
their bound and design.

``flash_attention`` dispatches on the device of ``q``: a CPU tensor goes
through the plain version (``repro_torch.kernels.ref.attention_ref``), a
CUDA tensor launches a kernel or raises, a ``meta`` tensor allocates what
the CUDA route allocates (the padded copies of a D tail, out, lse) and
adds :func:`cost` to ``_build.meta_cost``.  Which kernel is a rule on dtype
and head dim (:func:`tensor_core_route`): bf16 whose (padded) D is one of
``TENSOR_CORE_HEAD_DIMS`` (32-128, 160 for gemma2-27b's 144, and 288 for
gemma2-2b, whose keys come in 32-key tiles, ``ref.tc_key_tile``) runs the
tensor-core kernel (mma.sync, P rounded to bf16 for the PV product), f32
and every other D the CUDA-core kernel (P in f32).
Both kernels take D a multiple of 32; any other D up to 288 (gemma2-27b's
144) runs through :func:`run_padded`: q, k and v gain zero columns up to
the next multiple of 32, the scale stays 1/sqrt(D) of the true D, and the
output is cut back (a zero column adds nothing to a score, its output
column is dropped, and the logsumexp is unchanged).
``flash_attention.launches`` counts every launch;
``flash_fwd_tensor_core.launches`` and ``flash_fwd_cuda_core.launches``
count each kernel's, ``flash_d_tail.launches`` the padded calls' and
``FLASH_NON_CAUSAL.launches`` the calls without the causal mask (the
encdec encoder and cross-attention, where Sq and Skv differ: 448 queries
over 1,500 frames in training, one over 1,500 in decode).

``flash_attention_int8kv`` is the counterpart of the reference's
``flash_attention_int8kv``: the same attention over int8 K/V with
per-token scales, dequantized after the load, plus per-row query positions
(``q_start``, ``kv_len``) for the dense int8 decode cache.  Its kernel
(``csrc/flash_attention_int8kv.cu``) splits the key axis by
:func:`int8_split_plan` (shapes only) and merges the splits' partials in a
second kernel of the same call.  It dispatches and counts the same way
(:func:`int8_cost`); its plain version is ``ref.attention_int8kv_ref``.
With ``return_lse`` it also returns each row's log-sum-exp, computed from
the partials' (m, l) that the split kernel writes (the combine's own
weights), in PyTorch after the launch: the serve step's merge of
sequence slices needs it.

The backward (``flash_attention_bwd``) is PyTorch on any device: the JAX
package has no backward kernel (its gradient is XLA's autodiff of the jnp
``attention.attend``), so there is no TPU kernel to port there.  It
recomputes P per query chunk from the saved logsumexp, as the reference
rematerialises each query chunk (``jax.checkpoint(chunk_body)``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (BLOCKS_PER_SM, SM_COUNT,
                                                 device_sm_count)
from repro_torch.kernels.ref import attention_int8kv_ref, attention_ref

FLASH_NON_CAUSAL = _build.counter("flash_non_causal")

_fn = None
_fn_tc = None
_fn_int8kv = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 288
# the tensor-core kernel's instantiations (csrc/flash_attention.cu)
TENSOR_CORE_HEAD_DIMS = (32, 64, 96, 128, 160, 288)
INT8_ROWS = 16                  # folded query rows per row tile (int8 kernel)
INT8_KEY_UNIT = 16              # an int8 split's keys are a multiple of this
INT8_SMEM_BYTES = 64 * 1024     # an int8 split block's shared memory, at most


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_tc():
    global _fn_tc
    if _fn_tc is None:
        fn = _build.load("flash_attention").flash_attention_fwd_tc
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_tc = fn
    return _fn_tc


def _pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a flash call attends: query t sees keys ``<= t``
    under ``causal`` and within ``window``."""
    import numpy as np
    t = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(t + 1, Skv) if causal else np.full(Sq, Skv, np.int64)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def cost(B: int, Sq: int, Skv: int, H: int, KV: int, D: int, *,
         causal: bool = True, window: Optional[int] = None,
         itemsize: int = 2):
    """(bytes, flops) of one flash forward: q, k, v read once, out and lse
    written once; 4 flops per (query head, attended key, dim), counting
    the keys each query attends under the causal and window masks."""
    nbytes = (itemsize * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
              + 4 * B * H * Sq)
    return nbytes, 4 * B * H * D * _pairs(Sq, Skv, causal, window)


def int8_cost(B: int, Sq: int, H: int, KV: int, D: int, Skv: int, *,
              q_start=None, kv_len=None, window: Optional[int] = None,
              itemsize: int = 2, scale_bytes: int = 2):
    """(bytes, flops) of one int8 call: q and out once, and per row the
    int8 K and V codes and their scales of the keys its queries can reach
    (kv_len, causal, the window) once per kv head; 4 flops per (query
    head, attended key, dim).  ``q_start`` / ``kv_len``: each row's; None
    counts every row's queries at the end of the cache (``q_start = Skv -
    Sq``, ``kv_len = Skv``: the most the shapes can need, the ``meta``
    route's count)."""
    if q_start is None:
        q_start, kv_len = [max(0, Skv - Sq)] * B, [Skv] * B
    w = window
    keys = attended = 0
    for qs, n in zip(q_start, kv_len):
        def span(p):
            return (max(0, p - w + 1) if w else 0, min(n, Skv, p + 1))
        lo, hi = span(qs)[0], span(qs + Sq - 1)[1]
        keys += max(0, hi - lo)
        attended += sum(max(0, b - a) for a, b in
                        map(span, range(qs, qs + Sq)))
    q_bytes = B * Sq * H * D * itemsize
    nbytes = 2 * q_bytes + keys * KV * (2 * D + 2 * scale_bytes) + 8 * B
    return nbytes, 4 * H * D * attended


def tensor_core_route(dtype: torch.dtype, D: int) -> bool:
    """The routing rule: bf16 whose padded head dim (``padded_head_dim``)
    the tensor-core kernel is instantiated at (``TENSOR_CORE_HEAD_DIMS``:
    up to 128, 160, which gemma2-27b's 144 pads to, and gemma2-2b's 288)
    runs on the tensor cores; f32, and bf16 at any other D (192, 224,
    256), on the CUDA cores.  A true ``D`` and its padded one route
    alike."""
    return (dtype == torch.bfloat16
            and padded_head_dim(D) in TENSOR_CORE_HEAD_DIMS)


def p_rounding(dtype: torch.dtype, D: int) -> float:
    """The relative error of P in the PV product of the kernel that
    ``(dtype, D)`` routes to, the element-wise check's relative term:
    2^-8 where P is rounded to bf16 (2^-9, doubled for headroom), 2^-14
    where it stays f32 (2^10 f32 roundings of headroom for sums taken in
    another order)."""
    return 2.0 ** -8 if tensor_core_route(dtype, D) else 2.0 ** -14


@_build.counted
def flash_fwd_tensor_core(q, k, v, out, lse, scale, causal, window,
                          softcap):
    """Launch the tensor-core kernel into ``out`` and ``lse``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _entry_tc()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, H, KV, Sq, Skv, D, float(scale),
                    int(causal), int(window or 0), float(softcap or 0.0),
                    stream)
    _build.check(status, "flash_attention (tensor cores)")
    flash_fwd_tensor_core.launches += 1


@_build.counted
def flash_fwd_cuda_core(q, k, v, out, lse, scale, causal, window, softcap):
    """Launch the CUDA-core kernel into ``out`` and ``lse``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Skv, D,
                    float(scale), int(causal), int(window or 0),
                    float(softcap or 0.0), stream)
    _build.check(status, "flash_attention (CUDA cores)")
    flash_fwd_cuda_core.launches += 1


def _entry_int8kv():
    global _fn_int8kv
    if _fn_int8kv is None:
        fn = _build.load("flash_attention_int8kv").flash_attention_int8kv_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_int8kv = fn
    return _fn_int8kv


def int8_smem_bytes(D: int, keys: int) -> int:
    """Shared memory of one int8 split block (the kernel's
    ``split_smem_bytes``): K and V codes in rows of an odd number of 16-byte
    units, their scales, q and the scores in f32, (m, l) per row."""
    Dp = -(-D // 16) * 16
    KP = Dp + 16 if (Dp // 16) % 2 == 0 else Dp
    return 2 * keys * KP + 4 * (2 * keys + INT8_ROWS * Dp + INT8_ROWS * keys
                                + 2 * INT8_ROWS)


def int8_split_plan(B: int, KV: int, Skv: int, D: int, rows: int,
                    sm_count: int = SM_COUNT):
    """``(keys_per_split, splits)`` for an int8 call, from shapes only
    (never ``q_start`` or ``kv_len``: reading them would sync the host with
    the device on the decode path); ``rows`` is Sq * G, the folded query
    rows per kv head.

    Enough splits that the grid, ``splits`` x ``ceil(rows / INT8_ROWS)``
    row tiles x ``KV`` x ``B`` blocks, covers the ``sm_count`` SMs about
    ``BLOCKS_PER_SM`` times over, at B = 8 decode and at B = 1 prompt
    replay alike; a split is a multiple of ``INT8_KEY_UNIT`` keys within
    ``INT8_SMEM_BYTES`` of shared memory; ``keys_per_split * splits >=
    Skv``.  Which keys a split's block reads is
    :func:`ref.int8kv_split_ranges`."""
    unit = INT8_KEY_UNIT
    tiles = -(-rows // INT8_ROWS)
    fixed = int8_smem_bytes(D, 0)
    cap = max(unit, (INT8_SMEM_BYTES - fixed)
              // (int8_smem_bytes(D, 1) - fixed) // unit * unit)
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * KV * tiles))
    per = -(-Skv // want)                # keys a split, to give `want`
    per = min(cap, max(unit, -(-per // unit) * unit))
    return per, max(1, -(-Skv // per))


def _fold_heads(q, k, v):
    """Model layout -> the oracle's (BH, S, D), K/V repeated per group."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV

    def kv(t):
        return t.permute(0, 2, 1, 3)[:, :, None].expand(
            B, KV, G, Skv, D).reshape(B * H, Skv, D)

    return q.permute(0, 2, 1, 3).reshape(B * H, Sq, D), kv(k), kv(v)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None):
    """The plain PyTorch version at the kernel's layout (any device)."""
    B, Sq, H, D = q.shape
    out, lse = attention_ref(*_fold_heads(q, k, v), causal=causal,
                             window=window, softcap=softcap, scale=scale,
                             return_lse=True)
    return (out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).contiguous(),
            lse.reshape(B, H, Sq))


def padded_head_dim(D: int) -> int:
    """The head dim the kernels run a call of head dim ``D`` at: the next
    multiple of 32."""
    return -(-D // 32) * 32


def run_padded(fwd, q, k, v, *, scale: Optional[float] = None, **kw):
    """``fwd(q, k, v, scale=..., **kw) -> (out, lse)`` at the padded head
    dim: q, k and v gain zero columns up to :func:`padded_head_dim`, the
    scale stays ``1/sqrt(D)`` of the true D (or the caller's), and the
    output is cut back to D.  The zero columns add nothing to any score, so
    the scores, P and the logsumexp are the unpadded call's; the output's
    extra columns (P times zeros) are dropped."""
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if Dp == D:
        return fwd(q, k, v, scale=scale, **kw)
    pad = lambda t: torch.nn.functional.pad(t, (0, Dp - D)).contiguous()
    out, lse = fwd(pad(q), pad(k), pad(v), scale=scale, **kw)
    return out[..., :D].contiguous(), lse


def _check_cuda(q, k, v):
    """What the wrapper takes: q (B, Sq, H, D), k and v (B, Skv, KV, D),
    all on one device, contiguous, of one dtype (f32 or bf16); H a multiple
    of KV; D at most 288 (the kernels run D padded to a multiple of 32)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} vs "
                         f"q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[2]}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes D up to {MAX_HEAD_DIM}, got D={D}")


@_build.counted
def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """Dense attention with GQA, top-left causal mask, sliding window and
    logit softcap.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D), H = G * KV.
    Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32): lse is
    the logsumexp of each row's masked scores, ``-inf`` for a row with no
    valid key (whose output is zeros).
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type == "meta":
        B, Sq, H, D = q.shape
        _build.meta_cost.add("flash_attention", *cost(
            B, Sq, k.shape[1], H, k.shape[2], D, causal=causal,
            window=window, itemsize=q.element_size()))
        return run_padded(_flash_launch, q, k, v, **kw)
    if padded_head_dim(q.shape[-1]) != q.shape[-1]:
        out, lse = flash_d_tail(q, k, v, **kw)
    else:
        out, lse = run_padded(_flash_launch, q, k, v, **kw)
    flash_attention.launches += 1
    if not causal:
        FLASH_NON_CAUSAL.launches += 1
    return out, lse


@_build.counted
def flash_d_tail(q, k, v, **kw):
    """One launch at the padded head dim, for a head dim that is not a
    multiple of 32 (:func:`run_padded`)."""
    out, lse = run_padded(_flash_launch, q, k, v, **kw)
    flash_d_tail.launches += 1
    return out, lse


def _flash_launch(q, k, v, *, scale, causal, window, softcap):
    """One kernel launch at a head dim that is a multiple of 32."""
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return out, lse
    launch = (flash_fwd_tensor_core if tensor_core_route(q.dtype, D)
              else flash_fwd_cuda_core)
    launch(q, k, v, out, lse, scale, causal, window, softcap)
    return out, lse


def flash_attention_bwd(q, k, v, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, q_chunk: int = 512):
    """Gradients of ``flash_attention``'s output, in PyTorch (any device).

    Per chunk of ``q_chunk`` query rows, over only the keys the chunk can
    reach (causal and window bounds), in f32: P = exp(S - lse) (masked to
    0), dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(P * dP)) times
    ``1 - tanh^2`` under a softcap and times the scale, dQ = dS K,
    dK = dS^T Q; dK and dV sum over the G query heads of each kv head.
    rowsum(P * dP) equals rowsum(dO * O) with O in f32, so the output
    itself (rounded to q's dtype) is not needed.
    Returns (dq, dk, dv) in the dtypes of q, k, v.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(q)
    dk = torch.zeros((B, Skv, KV, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    lse5 = lse.reshape(B, KV, G, Sq)
    for c0 in range(0, Sq, q_chunk):
        c1 = min(Sq, c0 + q_chunk)
        t0 = max(0, c0 - window + 1) if window else 0
        t1 = min(Skv, c1) if causal else Skv
        if t1 <= t0:
            continue                              # no reachable key: dq = 0
        n = c1 - c0
        qc = q[:, c0:c1].float().reshape(B, n, KV, G, D)
        doc = dout[:, c0:c1].float().reshape(B, n, KV, G, D)
        kc, vc = kf[:, t0:t1], vf[:, t0:t1]
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc) * scale
        th = None
        if softcap is not None:
            th = torch.tanh(s / softcap)
            s = softcap * th
        qpos = torch.arange(c0, c1, device=dev)[:, None]
        kpos = torch.arange(t0, t1, device=dev)[None, :]
        mask = torch.ones((n, t1 - t0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        p = torch.where(mask, torch.exp(s - lse5[..., c0:c1, None]),
                        torch.zeros_like(s))
        dv[:, t0:t1] += torch.einsum("bkgqt,bqkgd->btkd", p, doc)
        dp = torch.einsum("bqkgd,btkd->bkgqt", doc, vc)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        if th is not None:
            ds = ds * (1.0 - th * th)
        ds = ds * scale
        dq[:, c0:c1] = torch.einsum("bkgqt,btkd->bqkgd", ds, kc).reshape(
            B, n, H, D).to(q.dtype)
        dk[:, t0:t1] += torch.einsum("bkgqt,bqkgd->btkd", ds, qc)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention`` (the kernel on the card, the
    plain version on the CPU); backward through ``flash_attention_bwd``.
    Saves q, k, v and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _check_int8kv_cuda(q, k8, k_scale, v8, v_scale, q_start, kv_len):
    """What the int8 kernel takes: everything on q's device and
    contiguous; q (B, Sq, H, D) f32 or bf16; k8, v8 (B, Skv, KV, D) int8
    with 4-byte aligned rows; scales (B, Skv, KV) in q's dtype; q_start and kv_len (B,) int32; H a multiple of KV; D a multiple
    of 4 and at most 288."""
    ts = {"q": q, "k8": k8, "k_scale": k_scale, "v8": v8,
          "v_scale": v_scale, "q_start": q_start, "kv_len": kv_len}
    for name, t in ts.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name in ("k_scale", "v_scale"):
        if ts[name].dtype != q.dtype:
            raise TypeError(f"{name} is {ts[name].dtype}, q is {q.dtype}: "
                            "the kernel takes them in one dtype")
    for name in ("k8", "v8"):
        if ts[name].dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {ts[name].dtype}")
        if ts[name].data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    for name in ("q_start", "kv_len"):
        if ts[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {ts[name].dtype}")
    if q.dim() != 4 or k8.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k8 {tuple(k8.shape)} "
                         "must be 4-d")
    B, _, H, D = q.shape
    Skv, KV = k8.shape[1], k8.shape[2]
    if v8.shape != k8.shape or k8.shape[0] != B or k8.shape[3] != D:
        raise ValueError(f"k8 {tuple(k8.shape)} / v8 {tuple(v8.shape)} vs "
                         f"q {tuple(q.shape)}")
    for name in ("k_scale", "v_scale"):
        if tuple(ts[name].shape) != (B, Skv, KV):
            raise ValueError(f"{name} {tuple(ts[name].shape)}, want "
                             f"{(B, Skv, KV)}")
    for name in ("q_start", "kv_len"):
        if tuple(ts[name].shape) != (B,):
            raise ValueError(f"{name} {tuple(ts[name].shape)}, B={B}")
    if H % KV != 0:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D % 4 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes D a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got D={D}")


@_build.counted
def flash_attention_int8kv(q, k8, k_scale, v8, v_scale, q_start, kv_len, *,
                           causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """Attention over int8 K/V with per-token scales and per-row query
    positions (forward only: the reference has no gradient through it).

    q: (B, Sq, H, D); k8, v8: (B, Skv, KV, D) int8; k_scale, v_scale:
    (B, Skv, KV), in q's dtype on the card; q_start, kv_len: (B,) int32 — query i of row b sits at
    ``q_start[b] + i`` and keys at or past ``kv_len[b]`` are masked.
    Returns (B, Sq, H, D) in q's dtype; see ``ref.attention_int8kv_ref``
    for the function and its rounding.  A CPU tensor runs that plain
    version; a CUDA tensor launches ``csrc/flash_attention_int8kv.cu`` or
    raises; a ``meta`` tensor allocates the output and the partials and
    adds :func:`int8_cost`.  ``return_lse``: ``(out, lse)``, lse (B, Sq,
    H) f32 the log-sum-exp of each row's masked scores (-inf for a row
    with no valid key), from the partials."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_int8kv_ref(q, k8, k_scale, v8, v_scale, q_start,
                                    kv_len, return_lse=return_lse, **kw)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"flash_attention_int8kv: no kernel for device {q.device}")
    _check_int8kv_cuda(q, k8, k_scale, v8, v_scale, q_start, kv_len)
    B, Sq, H, D = q.shape
    Skv, KV = k8.shape[1], k8.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    R = Sq * (H // KV)
    per, splits = int8_split_plan(B, KV, Skv, D, R,
                                  device_sm_count(q.device))
    out = torch.empty_like(q)
    part_ml = torch.empty((B, KV, splits, R, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, KV, splits, R, D), dtype=torch.float32,
                           device=q.device)
    if q.device.type == "meta":
        _build.meta_cost.add("flash_attention_int8kv", *int8_cost(
            B, Sq, H, KV, D, Skv, window=window, itemsize=q.element_size(),
            scale_bytes=k_scale.element_size()))
        return (out, _int8_lse(part_ml, Sq)) if return_lse else out
    fn = _entry_int8kv()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(),
                    v8.data_ptr(), v_scale.data_ptr(), q_start.data_ptr(),
                    kv_len.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                    part_acc.data_ptr(), _DTYPES[q.dtype], B, Sq, H, KV, Skv,
                    D, per, splits, float(scale), int(causal),
                    int(window or 0), float(softcap or 0.0), stream)
    _build.check(status, "flash_attention_int8kv")
    flash_attention_int8kv.launches += 1
    return (out, _int8_lse(part_ml, Sq)) if return_lse else out


def _int8_lse(part_ml, Sq: int):
    """Each row's log-sum-exp from the split kernel's partials
    (``part_ml`` (B, KV, splits, Sq * G, 2): m and l = sum exp(s - m) of
    each split, l = 0 for a split with no valid key): M + log sum_i l_i
    exp(m_i - M) over the splits with l_i > 0, -inf where there is none.
    Returns (B, Sq, KV * G)."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    live = l > 0
    M = torch.where(live, m, float("-inf")).amax(dim=2, keepdim=True)
    Ms = torch.where(torch.isfinite(M), M, 0.0)
    tot = torch.where(live, l * torch.exp(m - Ms), 0.0).sum(dim=2)
    lse = torch.where(tot > 0, Ms[:, :, 0] + torch.log(tot), float("-inf"))
    B, KV, R = lse.shape
    G = R // Sq
    return lse.reshape(B, KV, Sq, G).permute(0, 2, 1, 3).reshape(
        B, Sq, KV * G)


