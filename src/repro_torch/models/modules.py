"""Low-level modules as plain functions on tensors (params are dicts).

Counterpart of ``repro.models.modules``.  Weights keep the reference's
layout: a linear weight is ``(d_in, *out)`` (``init_linear``), a norm scale
is ``(d,)`` used as ``1 + scale`` in f32, the embedding table is
``(vocab, d)`` and doubles as the tied unembedding.  Compute happens in the
config's dtype (bf16): weights are cast to it on every call exactly as the
reference casts its f32 masters, so holding them in bf16 already gives the
same numbers with one cast fewer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """In-place truncated normal on [-2, 2] standard deviations (the
    reference's ``truncated_normal_init``; its numbers differ, the
    distribution does not)."""
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return t.mul_(stddev)


def drawer(generator: torch.Generator, device, dtype: torch.dtype):
    """``draw(shape, std, f32=False)``: one truncated-normal leaf on
    ``device`` in ``dtype`` (f32 where ``f32``), drawn on the generator's
    device.  A CPU generator draws each leaf whole in f32.  A generator on
    the card draws a leaf of more than two dims one slice of its leading
    axis at a time, in f32, into the leaf preallocated in its dtype: a
    full-width qwen3-moe (30.5 B parameters) is made in seconds, and no
    whole stacked leaf (38.6 GB as f32 for its experts) is ever held in
    f32.  The two differ because slices give other numbers than one whole
    draw: ``trunc_normal_`` (torch 2.13) rejects out-of-range values and
    redraws them over the whole tensor, so a CPU draw stays whole to keep
    the weights every earlier seed gave."""
    def whole(shape, std, f32=False):
        t = truncated_normal_(torch.empty(shape, dtype=torch.float32), std,
                              generator)
        return t.to(device, torch.float32 if f32 else dtype)

    def sliced(shape, std, f32=False):
        out = torch.empty(shape, dtype=torch.float32 if f32 else dtype,
                          device=device)
        for part in (out if out.dim() > 2 else (out,)):
            t = torch.empty(part.shape, dtype=torch.float32,
                            device=generator.device)
            part.copy_(truncated_normal_(t, std, generator))
        return out
    return whole if generator.device.type == "cpu" else sliced


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear(p, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """x (..., d_in) @ w (d_in, *out) [+ b] -> (..., *out).  With ``dtype``
    both operands are cast to it and the product comes out in it (f32
    accumulation inside the matmul, as ``preferred_element_type=x.dtype``
    gives in the reference)."""
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    out_shape = w.shape[1:]
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *out_shape)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` gain, in f32; the result comes out
    in ``out_dtype`` (default: x's dtype).  Runs the fused kernel
    (``kernels.ops.rmsnorm``) on a CUDA tensor, its plain version on a
    CPU tensor."""
    return ops.rmsnorm(x, p["scale"], eps=eps, out_dtype=out_dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm (whisper): (x - mean) * rsqrt(var + eps) * scale + bias,
    all in f32 (the biased variance, as ``jnp.var``), the result in
    ``out_dtype`` (default: x's dtype).  No TPU kernel computes it, so
    this plain version is the port, as the reference's jnp is."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed(p, tokens: torch.Tensor, dtype: Optional[torch.dtype] = None):
    rows = p["table"][tokens]
    return rows if dtype is None else rows.to(dtype)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: table cast to x's dtype, f32 accumulation, f32
    logits (the reference's ``preferred_element_type=float32``).  The
    products of two bf16 values are exact in f32, so an f32 matmul of the
    cast operands is that accumulation."""
    table = p["table"].to(x.dtype).float()
    return torch.matmul(x.float(), table.t())


# ---------------------------------------------------------------------------
# Activations / misc
# ---------------------------------------------------------------------------

# The activations run op for op in x's dtype, with constants rounded to it
# first, as the reference's jnp definitions do: in bf16 each op rounds its
# result, and a fused f32 evaluation rounded once differs in ~40% of values.

_consts: Dict[Tuple[float, torch.dtype, torch.device], torch.Tensor] = {}


def const(v: float, x: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to x's dtype, as a 0-d tensor on x's device.  Made
    once per (value, dtype, device) and kept: making it copies from
    pageable host memory, which a CUDA graph capture forbids, so a
    captured program's warm-up run makes every constant its capture
    reads, and the graph reads it at that address on every replay."""
    key = (v, x.dtype, x.device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(v, dtype=x.dtype, device=x.device)
    return t


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    inner = const(math.sqrt(2.0 / math.pi), x) * (
        x + const(0.044715, x) * (x ** 3))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def activation(name: str):
    return {"silu": silu, "gelu": gelu_tanh, "relu": torch.relu}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp(p, x: torch.Tensor, act: str = "silu",
        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = activation(act)
    h = a(linear(p["wg"], x, dtype)) * linear(p["wi"], x, dtype)
    return linear(p["wo"], h, dtype)
