"""Mamba-2 SSD chunked scan: CUDA kernels, plain PyTorch version, and the
autograd Function whose backward is PyTorch.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan``.  ``csrc/ssd_scan.cu``
holds two scans, chosen by :func:`tensor_core_route` (dtype and shapes,
never a failed build or launch):

- bf16 x, B and C with N and P multiples of 16, N <= 128, P <= 64 and L a
  multiple of 64 up to 256 (mamba2-1.3b's N 128, P 64, L 256; zamba2-1.2b's
  N 64): the
  tensor-core scan, three launches (C.B^T per chunk and group; per head
  the chunk states and the state passing over its chunks in f32; the
  outputs per chunk and head), with f32 workspaces from this wrapper;
- f32, and every other shape (the smoke configs' N 16, L 16): the CUDA-core
  scan, one launch, one block per ``(b, h)`` walking the chunks in order.

Both read x, B and C in the model layout (head h reads group h // (H / G)
of the un-repeated B and C).  See the source's header for their bound,
design and rounding points.  Like the TPU kernel they take ``S % L == 0``
(``L = min(chunk, S)``), no initial state and no D skip; ``ops.ssd`` pads
S to a chunk multiple.

``ssd_scan`` dispatches on the device of ``x``: a CPU tensor goes through
the plain version (``repro_torch.kernels.ref.ssd_scan_ref``), a CUDA tensor
launches a scan or raises, a ``meta`` tensor allocates the output (and the
tensor-core route's workspaces) and adds :func:`cost` to
``_build.meta_cost``.  ``ssd_scan.launches`` counts scans, one a call;
``ssd_tensor_core.launches`` and ``ssd_cuda_core.launches`` count them by
route (a tensor-core scan is the ``TC_KERNELS``' launches, one each).

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
_fn_tc = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128
MAX_HEAD_DIM = 64
TC_ROWS = 64          # the tensor-core scan's row tile; L is a multiple
TC_MAX_CHUNK = 256    # its states kernel's cum scan: one position a thread
TC_KERNELS = ("ssd_cb_kernel", "ssd_states_kernel", "ssd_output_kernel")
P_ROUNDING = 2.0 ** -8  # the element-wise bound's p (ref.
                        # rounding_bound_ratio) for the tensor-core scan: M,
                        # w x and h_enter enter its products as bf16 hi + lo
                        # pairs (2^-18), the rest is the decays' f32 error
                        # from summing cum in another order than the plain
                        # cumsum (a few 2^-24 |cum|)
CUDA_CORE_P_ROUNDING = 2.0 ** -14  # the same bound's p for the CUDA-core
                                   # scan, f32 throughout: 2^10 f32
                                   # roundings (2^-24 each) of headroom for
                                   # sums taken in another order


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_tc():
    global _fn_tc
    if _fn_tc is None:
        fn = _build.load("ssd_scan").ssd_scan_tc_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_tc = fn
    return _fn_tc


def tensor_core_route(dtype: torch.dtype, N: int, P: int, L: int) -> bool:
    """The routing rule: bf16 with N and P multiples of 16, N <= 128,
    P <= 64 and L a multiple of 64 up to 256 runs the tensor-core scan;
    f32 and every other shape the CUDA-core scan."""
    return (dtype == torch.bfloat16 and N % 16 == 0 and 16 <= N <= MAX_STATE
            and P % 16 == 0 and 16 <= P <= MAX_HEAD_DIM
            and L % TC_ROWS == 0 and TC_ROWS <= L <= TC_MAX_CHUNK)


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


def cost(b: int, S: int, H: int, P: int, G: int, N: int, L: int,
         itemsize: int = 2):
    """(bytes, flops) of one scan: x, dt, A, B, C read once, y written
    once (x, B, C, y of ``itemsize``).  Per chunk, 2 flops for each
    multiply-add: the masked C.B^T product (L(L+1)/2 N, j <= i only) once
    per group, as every head of a group shares it; per head the masked
    M.x product (L(L+1)/2 P), the state's contribution to y and the state
    update (L N P each)."""
    nc = -(-S // L)
    tri = L * (L + 1) // 2
    mac = b * nc * (G * tri * N + H * (tri * P + 2 * L * N * P))
    nbytes = (2 * (b * S * H * P * itemsize) + 2 * (b * S * G * N * itemsize)
              + b * S * H * 4 + H * 4)
    return nbytes, 2 * mac


def tc_workspaces(x, B, L):
    """The tensor-core scan's f32 workspaces: CB (b, nc, G, L, L), cum and
    dt (b, nc, H, L) each, the state entering each chunk (b, nc, H, N,
    P)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // L
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((b, nc, G, L, L), **f32),
            torch.empty((b, nc, H, L), **f32),
            torch.empty((b, nc, H, L), **f32),
            torch.empty((b, nc, H, N, P), **f32))


@_build.counted
def ssd_tensor_core(x, dt, A, B, C, y, L):
    """Launch the tensor-core scan into ``y`` (its three kernels)."""
    for name, t in (("x", x), ("B", B), ("C", C), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    ws = tc_workspaces(x, B, L)
    if x.device.type == "meta":
        return
    fn = _entry_tc()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in ws),
                    b, S, H, G, N, P, L, stream)
    _build.check(status, "ssd_scan (tensor cores)")
    ssd_tensor_core.launches += 1


@_build.counted
def ssd_cuda_core(x, dt, A, B, C, y, L):
    """Launch the CUDA-core scan into ``y``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, S, H, G,
                    N, P, L, stream)
    _build.check(status, "ssd_scan (CUDA cores)")
    ssd_cuda_core.launches += 1


@_build.counted
def ssd_scan(x, dt, A, B, C, chunk: int):
    """SSD scan with zero initial state.

    x: (b, S, H, P); dt: (b, S, H) f32; A: (H,) f32; B, C: (b, S, G, N),
    G | H; S a multiple of ``L = min(chunk, S)``.  Returns y (b, S, H, P)
    in x's dtype."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    S, P, N = x.shape[1], x.shape[3], B.shape[3]
    L = min(chunk, S)
    _check_cuda(x, dt, A, B, C, L)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    tc = tensor_core_route(x.dtype, N, P, L)
    if x.device.type == "meta":
        if tc:
            ssd_tensor_core(x, dt, A, B, C, y, L)   # its workspaces
        b, S, H = x.shape[:3]
        _build.meta_cost.add("ssd_scan", *cost(b, S, H, P, B.shape[2], N, L,
                                               x.element_size()))
        return y
    (ssd_tensor_core if tc else ssd_cuda_core)(x, dt, A, B, C, y, L)
    ssd_scan.launches += 1
    return y


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
