"""The tied unembedding's products on the tensor cores.

Counterpart of the reference's ``jnp.einsum(x, table.astype(x.dtype),
preferred_element_type=float32)`` (``repro.models.modules.unembed``):
bf16 operands, f32 accumulation, f32 logits.  The product of two bf16
values is exact in f32, so a tensor-core GEMM with bf16 operands and an
f32 output (``torch.mm(..., out_dtype=torch.float32)``) computes the
same products as an f32 GEMM of the upcast operands; only the order of
the sums differs.

The backward's cotangent g is f32.  :func:`unembed_split` writes each
f32 value exactly as the sum of three bf16 terms, hi = bf16(g), mid =
bf16(g - hi), lo = bf16(g - hi - mid) (exact for |g| from 2^-110 up to
2^127; below, lo falls under bf16's normal range and the sum misses by
less than 5e-41).  Each term times a bf16 operand is then exact in f32
too, so three bf16 GEMMs summed in f32 give the f32 GEMM up to the order
of the sums.  The terms sit side by side, (rows, 3, cols), so one GEMM with the
three concatenated along its contracted dim sums them:

    dX = [hi | mid | lo] @ [W; W; W]        (rows x 3c) @ (3c x d)
    dW = [hi; mid; lo]^T @ [x; x; x]        over the rows, interleaved

The vocabulary is taken ``chunk_cols(rows, d)`` columns at a time, so a
chunk's terms and its f32 dW rows take at most ``CHUNK_BYTES`` whatever
the vocabulary; dX sums the chunks.  A chunk's dW rows sum ``DW_ROWS``
rows a GEMM and add the GEMMs in f32 on the CUDA cores (rounded to
nearest), then are rounded into the bf16 gradient at once: the tensor
cores' f32 sums lose more than rounding to nearest does, and their error
grows with the length of the sum, as a truncating sum's does.  On an
H100 at qwen2-0.5b's training shape (32,736 rows, 151,936 x 896 table),
dW's largest error against f64 products of the same values read 14.1
sqrt(K) 2^-24 of the products' magnitudes' sum with all rows in one
GEMM, 0.57 at 1,024 rows a GEMM, and 0.85 for the f32 CUDA-core GEMM of
the upcast operands; dX (3 x chunk columns a GEMM) 0.41 against its
1.0.

``unembed_split`` dispatches on the device: the kernel
``csrc/unembed_split.cu`` on the card (one read of g, one write of each
term), its plain version (:func:`unembed_split_plain`) on the CPU, and
on ``meta`` the output's allocation and :func:`split_cost` in
``_build.meta_cost``.
:class:`TiedUnembed` is the autograd Function; ``modules.unembed``
routes bf16 x on the card and on ``meta`` to it.  Its products run as
``torch.mm`` with ``out_dtype`` (:func:`_mm`), which the CPU lacks; the
backward's chunk loop is :func:`backward_products`.
``unembed_tensor_core.launches`` counts the Function's calls (forwards
and backwards) off ``meta``: calls, not a kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CHUNK_BYTES = 2 ** 30       # a backward chunk's terms and f32 dW rows
COL_ALIGN = 64              # a chunk's columns: a multiple of this
DW_ROWS = 1024              # rows one dW GEMM sums on the tensor cores

unembed_tensor_core = _build.counter("unembed_tensor_core")
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("unembed_split").unembed_split
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def unembed_split_plain(g: torch.Tensor, out: torch.Tensor
                        ) -> torch.Tensor:
    """``out[:, 0] = hi, out[:, 1] = mid, out[:, 2] = lo`` of the f32
    (rows, cols) ``g`` (any row stride), in PyTorch; ``out`` (rows, 3,
    cols) bf16."""
    out[:, 0].copy_(g)
    r = g - out[:, 0].float()
    out[:, 1].copy_(r)
    out[:, 2].copy_(r - out[:, 1].float())
    return out


def split_cost(rows: int, cols: int):
    """(bytes, flops) of one split: g read once (4 bytes an element),
    three bf16 terms written (6); two subtractions an element."""
    n = rows * cols
    return 10 * n, 2 * n


@_build.counted
def unembed_split(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The three-term split of the f32 (rows, cols) ``g``, whose columns
    are contiguous (any row stride), into the contiguous (rows, 3, cols)
    bf16 ``out``; returns ``out``."""
    rows, cols = g.shape
    if g.dtype != torch.float32 or out.dtype != torch.bfloat16:
        raise TypeError(f"unembed_split takes f32 in, bf16 out; got "
                        f"{g.dtype} -> {out.dtype}")
    if tuple(out.shape) != (rows, 3, cols) or not out.is_contiguous():
        raise ValueError(f"out {tuple(out.shape)} for g {tuple(g.shape)}: "
                         f"want a contiguous {(rows, 3, cols)}")
    if g.device.type == "cpu":
        return unembed_split_plain(g, out)
    if g.device.type == "meta":
        _build.meta_cost.add("unembed_split", *split_cost(rows, cols))
        return out
    if g.stride(1) != 1:
        raise ValueError("unembed_split: g's columns must be contiguous")
    ld = g.stride(0)
    vec = (cols % 4 == 0 and ld % 4 == 0 and g.data_ptr() % 16 == 0
           and out.data_ptr() % 8 == 0)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(g.data_ptr(), out.data_ptr(), rows, cols, ld,
                          int(vec), stream)
    _build.check(status, "unembed_split")
    unembed_split.launches += 1
    return out


def chunk_cols(rows: int, d: int) -> int:
    """Columns of one backward chunk: as many as keep its three bf16
    terms (6 bytes a row) and its f32 dW rows and their next GEMM's
    (8 bytes a column of d) within ``CHUNK_BYTES``, rounded down to a
    multiple of ``COL_ALIGN`` (16-byte aligned rows for the GEMMs), at
    least ``COL_ALIGN``."""
    cols = CHUNK_BYTES // (6 * rows + 8 * d)
    return max(COL_ALIGN, cols // COL_ALIGN * COL_ALIGN)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with f32 accumulation and output: the
    tensor cores on the card, the allocation alone on ``meta``."""
    return torch.mm(a, b, out_dtype=torch.float32)


def backward_products(x2: torch.Tensor, table: torch.Tensor,
                      g: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The backward's products of the f32 cotangent ``g`` (n, V), whose
    columns are contiguous, against the bf16 ``x2`` (n, d) and ``table``
    (V, d): each chunk of ``chunk_cols(n, d)`` vocabulary columns split
    into three bf16 terms, its dW rows summed ``DW_ROWS`` rows a GEMM
    and written into ``dw`` (V, d; rounded to its dtype a chunk at a
    time), and dX returned in f32, summed over the chunks."""
    (n, d), V = x2.shape, table.shape[0]
    cols = chunk_cols(n, d)
    buf = torch.empty(n * 3 * min(cols, V), dtype=torch.bfloat16,
                      device=g.device)
    x3 = x2.repeat_interleave(3, dim=0)          # row 3i + t: x[i]
    dx = None
    for v0 in range(0, V, cols):
        c = min(cols, V - v0)
        terms = unembed_split(g[:, v0:v0 + c], buf[:n * 3 * c].view(n, 3, c))
        part = _mm(terms.view(n, 3 * c), table[v0:v0 + c].repeat(3, 1))
        dx = part if dx is None else dx.add_(part)
        t3, acc = terms.view(3 * n, c), None
        for r0 in range(0, 3 * n, 3 * DW_ROWS):
            rows = slice(r0, r0 + 3 * DW_ROWS)
            part = _mm(t3[rows].t(), x3[rows])
            acc = part if acc is None else acc.add_(part)
        dw[v0:v0 + c] = acc
    return dx


class TiedUnembed(torch.autograd.Function):
    """f32 logits of bf16 x (..., d) against the bf16 table (V, d).
    Saves x and the table; the backward (:func:`backward_products`)
    returns each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, table):
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, table)
        ctx.x_shape = x.shape
        if x.device.type != "meta":
            unembed_tensor_core.launches += 1
        return _mm(x2, table.t()).reshape(*x.shape[:-1], table.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        g = g.reshape(x2.shape[0], table.shape[0])
        if g.stride(1) != 1:
            g = g.contiguous()
        dw = torch.empty(table.shape, dtype=table.dtype, device=g.device)
        dx = backward_products(x2, table, g, dw)
        if x2.device.type != "meta":
            unembed_tensor_core.launches += 1
        return dx.to(x2.dtype).reshape(ctx.x_shape), dw
