"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) blocks.

Counterpart of ``repro.models.ssm``.  The full-sequence forward (training)
runs the chunked SSD scan through ``kernels.ops.ssd`` — the CUDA kernel on
the card, its plain version (``ssd_chunked``) on the CPU; decode is the
O(1) recurrent step over the (B, H, N, P) state.  Parameters keep the
reference's layout and leaves: ``in_proj`` (d, 2 di + 2 G N + H),
``conv_w`` (w, conv_dim), ``conv_b``, ``dt_bias``, ``A_log``, ``D``, the
gated ``norm`` and ``out_proj``; ``conv_*``, ``dt_bias``, ``A_log`` and
``D`` are used in f32 and so are held in f32 (``F32_LEAVES``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import modules as nn

# leaves the reference uses in f32 whatever the compute dtype
F32_LEAVES = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_mamba2(cfg, generator: torch.Generator, lead=(), device="cpu",
                weight_dtype: torch.dtype = torch.float32):
    """Random mamba2 weights, stacked with leading dims ``lead``, at the
    reference's stddevs and constant inits; the in/out projections are held
    in ``weight_dtype``, everything else in f32."""
    d, di, H = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_num_heads
    N, G, w = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv_width
    conv_dim = di + 2 * G * N
    d_in_proj = 2 * di + 2 * G * N + H
    lead = tuple(lead)

    draw = nn.drawer(generator, device, weight_dtype)

    def const(v):
        return v.expand(lead + v.shape).contiguous().to(device)

    # dt_bias = softplus^-1 of dt log-spaced over [1e-3, 1e-1]
    dt_target = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H,
                                         dtype=torch.float64))
    dt_init = torch.log(torch.expm1(dt_target)).float()
    return {
        "in_proj": {"w": draw(lead + (d, d_in_proj), 1.0 / math.sqrt(d))},
        "conv_w": draw(lead + (w, conv_dim), 1.0 / math.sqrt(w), True),
        "conv_b": const(torch.zeros((conv_dim,), dtype=torch.float32)),
        "dt_bias": const(dt_init),
        "A_log": const(torch.log(torch.arange(1, H + 1,
                                              dtype=torch.float32))),
        "D": const(torch.ones((H,), dtype=torch.float32)),
        "norm": {"scale": const(torch.zeros((di,), dtype=torch.float32))},
        "out_proj": {"w": draw(lead + (di, d), 1.0 / math.sqrt(di))},
    }


def _split_in_proj(cfg, zxbcdt):
    di, G, N = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    return z, xBC, dt


# ---------------------------------------------------------------------------
# SSD: the chunked scan and the one-token recurrence
# ---------------------------------------------------------------------------

# The chunked scan (x (b, S, H, P), dt (b, S, H), A (H,), B and C
# (b, S, G, N), optional initial state) -> (y, final_state).  It is the SSD
# kernel's plain version, so it lives with the kernels' plain versions.
ssd_chunked = ssd_scan_ref


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence.

    state: (b, H, N, P); x: (b, H, P); dt: (b, H); B, C: (b, G, N).
    Returns (y (b, H, P) in x's dtype, new_state f32)."""
    H, G = x.shape[1], B.shape[1]
    rep = H // G
    Bf = B.float().repeat_interleave(rep, dim=1)               # (b, H, N)
    Cf = C.float().repeat_interleave(rep, dim=1)
    dtf = dt.float()
    dec = torch.exp(dtf * A[None, :])                          # (b, H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dtf, Bf, x.float())
    new_state = dec[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Cf, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv1d over the (x, B, C) channels
# ---------------------------------------------------------------------------

def causal_conv1d(xBC, conv_w, conv_b, conv_state=None):
    """xBC: (b, S, Cdim); conv_w: (w, Cdim).  Returns (silu(out) in xBC's
    dtype, new_conv_state (b, w - 1, Cdim) f32).

    conv_state: (b, w - 1, Cdim) trailing inputs of earlier steps (decode).
    The w taps are summed in order starting from 0, in f32, as the
    reference's ``sum(...)`` does."""
    w = conv_w.shape[0]
    xf = xBC.float()
    if conv_state is None:
        pad = torch.zeros((xf.shape[0], w - 1, xf.shape[2]),
                          dtype=torch.float32, device=xf.device)
    else:
        pad = conv_state.float()
    xp = torch.cat([pad, xf], dim=1)                           # (b, S+w-1, C)
    S = xf.shape[1]
    cw = conv_w.float()
    out = 0
    for i in range(w):
        out = out + xp[:, i:i + S] * cw[i][None, None]
    out = out + conv_b.float()[None, None]
    new_state = xp[:, -(w - 1):] if w > 1 else pad
    return nn.silu(out).to(xBC.dtype), new_state


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def scan_inputs(p, cfg, x, conv_state=None):
    """What ``mamba2_block`` feeds the SSD scan: the in-projection, the
    causal conv (``conv_state`` for decode) and dt.  x: (B, S, d_model).
    Returns (z, xs (B, S, H, P), dt (B, S, H) f32, A (H,) f32, B and C
    (B, S, G, N), new conv state)."""
    Bsz, S, _ = x.shape
    di, H, N, G, P = (cfg.ssm_d_inner, cfg.ssm_num_heads, cfg.ssm_state,
                      cfg.ssm_groups, cfg.ssm_head_dim)
    zxbcdt = nn.linear(p["in_proj"], x, dtype=getattr(torch, cfg.dtype))
    z, xBC, dt_raw = _split_in_proj(cfg, zxbcdt)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float()[None, None])
    A = -torch.exp(p["A_log"].float())                         # (H,)
    xBC, new_conv = causal_conv1d(xBC, p["conv_w"], p["conv_b"],
                                  conv_state=conv_state)
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    Bmat = xBC[..., di:di + G * N].reshape(Bsz, S, G, N)
    Cmat = xBC[..., di + G * N:].reshape(Bsz, S, G, N)
    return z, xs, dt, A, Bmat, Cmat, new_conv


def mamba2_block(p, cfg, x, cache=None):
    """x: (B, S, d_model).  cache: {"ssm": (B, H, N, P), "conv":
    (B, w - 1, Cdim)} for one-token decode (S == 1).  Returns
    (out (B, S, d_model) in the compute dtype, new_cache or None)."""
    Bsz, S, _ = x.shape
    di = cfg.ssm_d_inner
    dt_ = getattr(torch, cfg.dtype)
    Df = p["D"].float()
    z, xs, dt, A, Bmat, Cmat, new_conv = scan_inputs(
        p, cfg, x, conv_state=None if cache is None else cache["conv"])

    if cache is not None:
        xs = xs[:, 0]
        y, new_ssm = ssd_decode_step(cache["ssm"], xs, dt[:, 0], A,
                                     Bmat[:, 0], Cmat[:, 0])
        y = y.float() + Df[None, :, None] * xs.float()
        y = y.reshape(Bsz, 1, di).to(dt_)
        new_cache = {"ssm": new_ssm.to(cache["ssm"].dtype),
                     "conv": new_conv.to(cache["conv"].dtype)}
    else:
        y = ops.ssd(xs, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk)
        y = y.float() + Df[None, None, :, None] * xs.float()
        y = y.reshape(Bsz, S, di).to(dt_)
        new_cache = None

    # gated RMSNorm (norm before out_proj; the silu(z) gate in f32, then
    # rounded).  The norm reads the product y * gate unrounded, in f32: the
    # reference's compiled program folds the product's bf16 rounding into
    # the norm's f32 convert (as for the dense family's residual, x_sum).
    gate = nn.silu(z.float()).to(dt_)
    y = nn.rmsnorm(p["norm"], y.float() * gate.float(), eps=cfg.norm_eps,
                   out_dtype=dt_)
    return nn.linear(p["out_proj"], y, dtype=dt_), new_cache


def init_mamba2_cache(cfg, batch: int, dtype=torch.float32, device="cpu"):
    H, N, P = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, N, P), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
