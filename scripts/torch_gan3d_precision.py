#!/usr/bin/env python3
"""How exact the 3DGAN's f32 gradients are, against f64, on each path.

The port's ``models/gan3d.py`` runs its convolutions in f32: on the card
through cuDNN with TF32 off, on the CPU through PyTorch's native kernels
(not oneDNN's).  This script measures why, at full width, batch 8, from
the weights, batch and z ``chip_smoke.py`` uses (seeds 0, 1, 2):

1. one c3-sized convolution (8 x 16 x 28^3 -> 8 channels) on the card with
   TF32 on and off, against f64 on the CPU;
2. the gradients of ``d_loss`` (D's leaves) and ``g_loss`` (G's leaves),
   each leaf's max |f32 - f64| / max |f64|, for the CPU with oneDNN, the
   CPU as the port runs it, and the card as the port runs it.

  python scripts/torch_gan3d_precision.py            # card and CPU
  python scripts/torch_gan3d_precision.py --cpu-only
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import bridge, optim  # noqa: E402
from repro_torch.data import CalorimeterSpec, generate_batch  # noqa: E402
from repro_torch.distributed.stepfn import value_and_grad  # noqa: E402
from repro_torch.models import gan3d as G  # noqa: E402


def conv_tf32(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, 28, 28, 28, generator=gen)
    w = torch.randn(8, 16, 3, 3, 3, generator=gen) / 20
    truth = F.conv3d(x.double(), w.double(), padding=1)
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        y = F.conv3d(x.to(dev), w.to(dev), padding=1).double().cpu()
        out[f"tf32={tf32}"] = float((y - truth).abs().max()
                                    / truth.abs().max())
    torch.backends.cudnn.allow_tf32 = prev
    return out


@contextlib.contextmanager
def _onednn(x):
    """``G._ieee_f32`` as it would be with oneDNN left on for the CPU."""
    yield


def grad_errors(dev, onednn: bool = False) -> dict:
    cfg = G.GAN3DConfig()
    g0 = G.init_generator(cfg, torch.Generator().manual_seed(0))
    d0 = G.init_discriminator(cfg, torch.Generator().manual_seed(1))
    zgen = torch.Generator().manual_seed(2)
    batch = {k: torch.from_numpy(v)
             for k, v in generate_batch(CalorimeterSpec(), 8, 0).items()}
    z1 = torch.randn(8, cfg.latent_dim, generator=zgen)
    z2 = torch.randn(8, cfg.latent_dim, generator=zgen)

    def grads(where, dtype):
        def tm(t):
            return t.to(where, dtype)
        g, d = optim.tree_map(tm, g0), optim.tree_map(tm, d0)
        b = {k: tm(v) for k, v in batch.items()}
        _, _, gd = value_and_grad(
            lambda p, a: G.d_loss(p, g, cfg, a, tm(z1)), d, b)
        _, _, gg = value_and_grad(
            lambda p, a: G.g_loss(p, d, cfg, a, tm(z2)), g, b)
        return {"D": bridge.to_flat(gd), "G": bridge.to_flat(gg)}

    truth = grads("cpu", torch.float64)
    saved = G._ieee_f32
    if onednn:
        G._ieee_f32 = _onednn
    try:
        got = grads(dev, torch.float32)
    finally:
        G._ieee_f32 = saved
    return {tree: {k: float(np.abs(got[tree][k] - v).max()
                            / max(np.abs(v).max(), 1e-300))
                   for k, v in truth[tree].items()}
            for tree in truth}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args(argv)
    dnn = [ln.strip() for ln in torch.__config__.show().splitlines()
           if "DNN v" in ln]
    print(f"torch {torch.__version__}; {dnn[0] if dnn else 'no oneDNN'}")
    res = {"cpu_onednn": grad_errors("cpu", onednn=True),
           "cpu_port": grad_errors("cpu")}
    if not args.cpu_only:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --cpu-only")
        dev = torch.device("cuda")
        print(f"card: {torch.cuda.get_device_name(dev)}")
        res["card_conv_c3"] = conv_tf32(dev)
        res["card_port"] = grad_errors(dev)
    for k, v in res.items():
        print(f"{k}: {json.dumps(v)}", flush=True)
    for k in ("cpu_onednn", "cpu_port", "card_port"):
        if k in res:
            worst = {t: max(e.values()) for t, e in res[k].items()}
            print(f"{k} worst leaf error: {json.dumps(worst)}")
    return res


if __name__ == "__main__":
    main()
