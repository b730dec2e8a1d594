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
from typing import Optional

import torch


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """In-place truncated normal on [-2, 2] standard deviations (the
    reference's ``truncated_normal_init``; its numbers differ, the
    distribution does not)."""
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return t.mul_(stddev)


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
    in ``out_dtype`` (default: x's dtype)."""
    dt = out_dtype or x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(dt)


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

def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    inner = _const(math.sqrt(2.0 / math.pi), x) * (
        x + _const(0.044715, x) * (x ** 3))
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
