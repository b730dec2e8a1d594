"""Mamba-2 SSD chunked scan: CUDA kernel, plain PyTorch version, and the
autograd Function whose backward is PyTorch.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan``.  The kernel
(``csrc/ssd_scan.cu``) runs one thread block per ``(b, h)`` that walks the
chunks in order with the (N, P) state in shared memory, reading x, B and C
in the model layout (head h reads group h // (H / G) of the un-repeated
B and C).  See the source's header for its bound and design.  Like the TPU
kernel it takes ``S % L == 0`` (``L = min(chunk, S)``), no initial state
and no D skip; ``ops.ssd`` pads S to a chunk multiple.

``ssd_scan`` dispatches on the device of ``x``: a CPU tensor goes through
the plain version (``repro_torch.kernels.ref.ssd_scan_ref``), a CUDA tensor
launches the kernel or raises.  ``ssd_scan.launches`` counts kernel
launches only.

The backward is PyTorch on any device: the JAX package has no backward
kernel (its gradient is XLA's autodiff of ``ssd_chunked``), so
``SSDScan.backward`` recomputes the plain version under autograd and
returns its vector-Jacobian product.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128
MAX_HEAD_DIM = 64


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """The plain PyTorch version at the kernel's layout (any device)."""
    return ssd_scan_ref(x, dt, A, B, C, chunk)[0]


def _check_cuda(x, dt, A, B, C, L):
    """What the kernel takes: x (b, S, H, P), dt (b, S, H) f32, A (H,) f32,
    B and C (b, S, G, N) of x's dtype (f32 or bf16), all on one device and
    contiguous; G divides H; N a multiple of 4 up to 128; P up to 64;
    S a multiple of L."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (b, S, H, P), got {tuple(x.shape)}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (b, S, H) or A.shape != (H,)
            or B.shape != (b, S, G, N) or C.shape != B.shape):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} "
                         f"C {tuple(C.shape)}")
    if H % G != 0:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if N % 4 != 0 or N > MAX_STATE:
        raise ValueError(f"kernel takes N a multiple of 4 up to {MAX_STATE}, "
                         f"got N={N}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes P up to {MAX_HEAD_DIM}, got P={P}")
    if S % L != 0:
        raise ValueError(f"S={S} is not a multiple of the chunk {L}; "
                         "ops.ssd pads it")


def ssd_scan(x, dt, A, B, C, chunk: int):
    """SSD scan with zero initial state.

    x: (b, S, H, P); dt: (b, S, H) f32; A: (H,) f32; B, C: (b, S, G, N),
    G | H; S a multiple of ``L = min(chunk, S)``.  Returns y (b, S, H, P)
    in x's dtype."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    b, S, H, P = x.shape
    L = min(chunk, S)
    _check_cuda(x, dt, A, B, C, L)
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, S, H, G,
                    N, P, L, stream)
    _build.check(status, "ssd_scan")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """Forward through ``ssd_scan`` (the kernel on the card, the plain
    version on the CPU); backward: the vector-Jacobian product of the
    plain version, recomputed.  Saves the inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        ins = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
            y = ssd_scan_plain(*leaves, ctx.chunk)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(got) if n else None for n in need), None)
