"""3DGAN — the paper's production workload (counterpart of
``repro.models.gan3d``).

A 3-D convolutional auxiliary-classifier GAN for electromagnetic
calorimeter showers: the generator maps (latent, primary energy) to a
25x25x25 energy-deposition image; the discriminator outputs a real/fake
logit plus regressions of the primary energy and the total deposition.
About 1.05 M parameters at full width, trained with RMSProp.

Layouts.  Images enter and leave in the reference's layout, (B, G, G, G, 1)
(channels last; with one channel that is the same memory as NCDHW).
Inside, activations are NCDHW and conv weights OIDHW, ``F.conv3d``'s
layout, where the reference's are NDHWC / DHWIO (``bridge.gan_from_flat``
transposes the weights).  Two reshapes depend on that order and follow the
reference's: the generator's ``fc`` output is read as (B, 7, 7, 7, ch),
and the discriminator flattens its last volume channels last, so the
heads' (4096, 1) weights index the same features as the reference's.

Numerics.  The reference convolves in f32.  cuDNN would round f32
convolution inputs to TF32 (``torch.backends.cudnn.allow_tf32`` is on by
default), so ``conv3d`` runs forward and backward with it off; on the CPU
it runs PyTorch's native convolutions (see ``_ieee_f32``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.modules import linear, truncated_normal_


@dataclass(frozen=True)
class GAN3DConfig:
    name: str = "3dgan"
    grid: int = 25
    latent_dim: int = 200
    g_fc_ch: int = 10            # channels of the 7x7x7 seed volume
    g_base: int = 32
    d_base: int = 16
    e_scale: float = 100.0       # energy normalization (GeV)
    # loss weights (adversarial, energy regression, total-deposition)
    w_adv: float = 1.0
    w_energy: float = 0.1
    w_ecal: float = 0.1


# ---------------------------------------------------------------------------
# conv3d helpers
# ---------------------------------------------------------------------------

def init_conv3d(k: int, cin: int, cout: int, generator: torch.Generator,
                device="cpu"):
    """OIDHW weight, truncated normal of stddev 1/sqrt(k^3 cin); zero
    bias."""
    w = truncated_normal_(torch.empty(cout, cin, k, k, k), 1.0
                          / math.sqrt(k ** 3 * cin), generator)
    return {"w": w.to(device), "b": torch.zeros(cout, device=device)}


@contextlib.contextmanager
def _ieee_f32(x: torch.Tensor):
    """Convolutions exact to f32 rounding inside the block: cuDNN without
    TF32 on the card; PyTorch's native kernels, not oneDNN's, on the CPU
    (with oneDNN, torch 2.11 on an AMX host gave the generator's gradients
    2.6e-3 relative error against f64, where the native kernels and the
    card agree with f64 within 1e-6)."""
    if x.is_cuda:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    else:
        with torch.backends.mkldnn.flags(enabled=False):
            yield


class _Conv3d(torch.autograd.Function):
    """``F.conv3d`` whose backward convolutions also run without TF32:
    autograd runs them after the forward's block has closed."""

    @staticmethod
    def forward(ctx, x, w, stride: int, pad: int):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pad = stride, pad
        with _ieee_f32(x):
            return F.conv3d(x, w, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _ieee_f32(x):
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv3d_input(x.shape, w, gy, ctx.stride,
                                                ctx.pad)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv3d_weight(x, w.shape, gy, ctx.stride,
                                                 ctx.pad)
        return gx, gw, None, None


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: out = ceil(n / stride), the total
    padding split ``lo = total // 2``, ``hi = total - lo``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv3d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv of NCDHW ``x`` with OIDHW ``p["w"]``, plus bias."""
    k = p["w"].shape[-1]
    pads = [same_padding(n, k, stride) for n in x.shape[2:]]
    if all(lo == hi == pads[0][0] for lo, hi in pads):
        pad = pads[0][0]
    else:                       # asymmetric: pad explicitly (last axis first)
        x = F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        pad = 0
    y = _Conv3d.apply(x, p["w"].to(x.dtype), stride, pad)
    return y + p["b"].to(x.dtype)[:, None, None, None]


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: slope 1 at x == 0, where
    ``F.leaky_relu`` takes 0.2.  Zero inputs and zero biases make exact
    zeros common in the discriminator's first layers (the showers are
    sparse), so the choice moves their bias gradients."""
    return torch.where(x >= 0, x, 0.2 * x)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    for axis in (2, 3, 4):
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x


def _init_linear(d_in: int, d_out: int, generator: torch.Generator,
                 device="cpu"):
    w = truncated_normal_(torch.empty(d_in, d_out), 1.0 / math.sqrt(d_in),
                          generator)
    return {"w": w.to(device), "b": torch.zeros(d_out, device=device)}


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def init_generator(cfg: GAN3DConfig, generator: torch.Generator,
                   device="cpu"):
    b = cfg.g_base
    return {
        "fc": _init_linear(cfg.latent_dim + 1, 7 * 7 * 7 * cfg.g_fc_ch,
                           generator, device),
        "c1": init_conv3d(3, cfg.g_fc_ch, b, generator, device),
        "c2": init_conv3d(3, b, b // 2, generator, device),
        "c3": init_conv3d(3, b // 2, b // 4, generator, device),
        "c4": init_conv3d(3, b // 4, 1, generator, device),
    }


def generator(params, cfg: GAN3DConfig, z: torch.Tensor,
              energy: torch.Tensor) -> torch.Tensor:
    """z: (B, latent); energy: (B,) GeV -> image (B, G, G, G, 1) (>= 0)."""
    e = (energy / cfg.e_scale)[:, None].to(z.dtype)
    h = linear(params["fc"], torch.cat([z, e], dim=1))
    h = _leaky_relu(h).reshape(-1, 7, 7, 7, cfg.g_fc_ch)
    h = h.permute(0, 4, 1, 2, 3).contiguous()            # NDHWC -> NCDHW
    h = _leaky_relu(conv3d(params["c1"], h))
    h = _upsample2(h)                                    # 14^3
    h = _leaky_relu(conv3d(params["c2"], h))
    h = _upsample2(h)                                    # 28^3
    h = _leaky_relu(conv3d(params["c3"], h))
    h = h[:, :, :cfg.grid, :cfg.grid, :cfg.grid]         # crop to 25^3
    img = F.softplus(conv3d(params["c4"], h))
    img = img * (energy[:, None, None, None, None] / cfg.e_scale)
    return img.permute(0, 2, 3, 4, 1)                    # (B, G, G, G, 1)


# ---------------------------------------------------------------------------
# Discriminator (ACGAN: validity + auxiliary regressions)
# ---------------------------------------------------------------------------

def init_discriminator(cfg: GAN3DConfig, generator: torch.Generator,
                       device="cpu"):
    b = cfg.d_base
    flat = 4 * 4 * 4 * 4 * b
    return {
        "c1": init_conv3d(5, 1, b, generator, device),
        "c2": init_conv3d(5, b, 2 * b, generator, device),
        "c3": init_conv3d(5, 2 * b, 4 * b, generator, device),
        "head_adv": _init_linear(flat, 1, generator, device),
        "head_energy": _init_linear(flat, 1, generator, device),
        "head_ecal": _init_linear(flat, 1, generator, device),
    }


def _flatten_channels_last(h: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, D*H*W*C) in the reference's NDHWC order, the
    order the heads' weight rows index."""
    return h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)


def discriminator(params, cfg: GAN3DConfig, img: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """img: (B, G, G, G, 1) -> dict(adv_logit, energy_pred, ecal_pred)."""
    x = torch.log1p(img).permute(0, 4, 1, 2, 3)          # dynamic-range squash
    h = _leaky_relu(conv3d(params["c1"], x, stride=2))     # 13^3
    h = _leaky_relu(conv3d(params["c2"], h, stride=2))     # 7^3
    h = _leaky_relu(conv3d(params["c3"], h, stride=2))     # 4^3
    h = _flatten_channels_last(h)
    return {
        "adv_logit": linear(params["head_adv"], h)[:, 0],
        "energy_pred": F.relu(linear(params["head_energy"], h))[:, 0]
        * cfg.e_scale,
        "ecal_pred": F.relu(linear(params["head_ecal"], h))[:, 0]
        * cfg.e_scale,
    }


# ---------------------------------------------------------------------------
# Losses (the paper's custom multi-term loss)
# ---------------------------------------------------------------------------

def _bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    # one-sided label smoothing on the real label (GAN stabilizer)
    target = min(target, 0.9)
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def _mape(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true) / (torch.abs(true) + 1e-3))


def d_loss(d_params, g_params, cfg: GAN3DConfig, batch, z):
    real, energy = batch["images"], batch["energies"]
    fake = generator(g_params, cfg, z, energy)
    out_r = discriminator(d_params, cfg, real)
    out_f = discriminator(d_params, cfg, fake.detach())
    ecal_true = torch.sum(real, dim=(1, 2, 3, 4))
    loss = (cfg.w_adv * (_bce(out_r["adv_logit"], 1.0)
                         + _bce(out_f["adv_logit"], 0.0))
            + cfg.w_energy * _mape(out_r["energy_pred"], energy)
            + cfg.w_ecal * _mape(out_r["ecal_pred"], ecal_true))
    acc_real = torch.mean((out_r["adv_logit"] > 0).float())
    acc_fake = torch.mean((out_f["adv_logit"] < 0).float())
    return loss, {"d_loss": loss, "acc_real": acc_real, "acc_fake": acc_fake}


def g_loss(g_params, d_params, cfg: GAN3DConfig, batch, z):
    energy = batch["energies"]
    fake = generator(g_params, cfg, z, energy)
    out_f = discriminator(d_params, cfg, fake)
    ecal_fake = torch.sum(fake, dim=(1, 2, 3, 4))
    # generator wants: fool the adversary AND respect the physics heads
    loss = (cfg.w_adv * _bce(out_f["adv_logit"], 1.0)
            + cfg.w_energy * _mape(out_f["energy_pred"], energy)
            + cfg.w_ecal * _mape(out_f["ecal_pred"], ecal_fake))
    return loss, {"g_loss": loss, "fake_total_e": torch.mean(ecal_fake)}


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
