"""Fused RMSNorm: CUDA kernel, plain PyTorch version, and the autograd
Function whose backward is PyTorch.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm``, which computes the same
function as the reference's jnp ``modules.rmsnorm``: x * rsqrt(mean(x^2) +
eps) * (1 + scale) in f32.  ``csrc/rmsnorm.cu`` holds two kernels, chosen
by :func:`one_pass_route` (d and alignment): the one-pass kernel reads each
row once into registers, one group of threads a row (:func:`one_pass_plan`,
shapes only), for d a multiple of 8 up to 8,192 with aligned rows; the
two-pass kernel, one warp a row, takes every other d (element by element
where d % 8 != 0 or a row is misaligned).  See the source's header for
their bound and design.  Unlike the
Pallas kernel, whose output takes x's dtype, it writes ``out_dtype`` (f32
or bf16), so a norm can read the unrounded f32 residual and hand bf16 on.

``rmsnorm`` dispatches on the device of ``x``: a CPU tensor goes through
the plain version (``repro_torch.kernels.ref.rmsnorm_ref``), a CUDA tensor
launches a kernel or raises, a ``meta`` tensor allocates the output and
adds :func:`cost` to ``_build.meta_cost``.  ``rmsnorm.launches`` counts kernel launches
only; ``rmsnorm_one_pass.launches`` and ``rmsnorm_two_pass.launches`` count
them by route.

The backward (``rmsnorm_bwd``) is PyTorch on any device: the JAX package
has no backward kernel (its gradient is XLA's autodiff of the jnp norm).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_fn = None
_fn_one = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PACK = 8                  # elements a thread loads at once (16 bytes of bf16)
ONE_PASS_MAX_D = 8192     # the one-pass kernel's widest row
ONE_PASS_MAX_PPT = 4      # packs a thread holds, at most
ONE_PASS_BLOCK = 256      # threads a one-pass block, at most


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_one_pass():
    global _fn_one
    if _fn_one is None:
        fn = _build.load("rmsnorm").rmsnorm_one_pass_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_one = fn
    return _fn_one


def one_pass_route(d: int, aligned: bool) -> bool:
    """The routing rule: d a multiple of 8 up to 8,192 with x, scale and
    out 16-byte aligned runs the one-pass kernel; every other d or
    alignment the two-pass kernel."""
    return aligned and d % PACK == 0 and 0 < d <= ONE_PASS_MAX_D


def one_pass_plan(d: int):
    """``(packs a thread, threads a row, rows a block)`` of the one-pass
    kernel for rows of ``d`` (shapes only): as few packs of 8 a thread as
    keep a row within 256 threads, the row's threads rounded up to a whole
    number of warps, and as many rows a block as fill 256 threads."""
    packs = d // PACK
    ppt = -(-packs // ONE_PASS_BLOCK)
    tpr = 32 * -(-(-(-packs // ppt)) // 32)
    return ppt, tpr, max(1, ONE_PASS_BLOCK // tpr)


def cost(rows: int, d: int, in_bytes: int, out_bytes: int):
    """(bytes, flops) of one call on ``rows`` rows of ``d``: x read once,
    y written once, the scale read once; 4 flops an element
    (square-add, the two scalings, 1 + scale)."""
    n = rows * d
    return n * (in_bytes + out_bytes) + d * 4, 4 * n


@_build.counted
def rmsnorm_one_pass(x, scale, out, eps):
    """Launch the one-pass kernel into ``out`` (rows of x's last dim)."""
    d = x.shape[-1]
    ppt, tpr, rpb = one_pass_plan(d)
    fn = _entry_one_pass()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                    _DTYPES[x.dtype], _DTYPES[out.dtype], x.numel() // d, d,
                    float(eps), ppt, tpr, rpb, stream)
    _build.check(status, "rmsnorm (one pass)")
    rmsnorm_one_pass.launches += 1


@_build.counted
def rmsnorm_two_pass(x, scale, out, eps, vec: bool):
    """Launch the two-pass kernel into ``out``; ``vec``: packs of 8."""
    d = x.shape[-1]
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                    _DTYPES[x.dtype], _DTYPES[out.dtype], x.numel() // d, d,
                    float(eps), int(vec), stream)
    _build.check(status, "rmsnorm (two passes)")
    rmsnorm_two_pass.launches += 1


@_build.counted
def rmsnorm(x, scale, *, eps: float = 1e-6,
            out_dtype: Optional[torch.dtype] = None):
    """x (..., d) f32 or bf16; scale (d,).  Returns the norm of each row in
    ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 in and out, got "
                        f"{x.dtype} -> {out_dtype}")
    if scale.device != x.device or scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} on {scale.device}; "
                         f"want ({d},) on {x.device}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    x = x.contiguous()
    scale = scale.contiguous()
    rows = x.numel() // d if d else 0
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if rows == 0:
        return out
    if x.device.type == "meta":
        _build.meta_cost.add("rmsnorm", *cost(rows, d, x.element_size(),
                                              out.element_size()))
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    if one_pass_route(d, aligned):
        rmsnorm_one_pass(x, scale, out, eps)
    else:
        rmsnorm_two_pass(x, scale, out, eps, aligned and d % PACK == 0)
    rmsnorm.launches += 1
    return out


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """Gradients of ``rmsnorm`` (PyTorch, f32, any device).  With
    r = rsqrt(mean(x^2) + eps) and g = 1 + scale:
    dx = r * (dy g - x r^2 mean(dy g x)), dscale = sum over rows of
    dy x r.  Returns (dx in x's dtype, dscale in scale's dtype)."""
    xf, dyf = x.float(), dy.float()
    g = 1.0 + scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyg = dyf * g
    dx = r * (dyg - xf * (r * r) * (dyg * xf).mean(dim=-1, keepdim=True))
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """Forward through ``rmsnorm`` (the kernel on the card, the plain
    version on the CPU); backward through ``rmsnorm_bwd``.  Saves x and
    scale."""

    @staticmethod
    def forward(ctx, x, scale, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps=eps, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None, None
