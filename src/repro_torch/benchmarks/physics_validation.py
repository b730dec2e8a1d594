"""3DGAN physics validation (the port of ``benchmarks/physics_validation.py``'s
flow).

The standard validation observables of the CERN 3DGAN studies:

  * longitudinal shower profile (energy vs depth z),
  * lateral profile (energy vs the first transverse axis),
  * total deposited energy vs primary energy (sampling-fraction linearity).

``run`` trains a small 3DGAN briefly on the synthetic-MC source, then
compares those observables between generated and "MC" showers: chi2-like
normalized-profile distances, the depth of the shower maximum and the
energy-response correlation.  The same five rows as the reference.

  PYTHONPATH=src python -m repro_torch.benchmarks.physics_validation
  PYTHONPATH=src python -m repro_torch.benchmarks.physics_validation --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.data import CalorimeterSpec, generate_batch
from repro_torch.distributed.stepfn import value_and_grad
from repro_torch.models import gan3d as G


def profiles(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(longitudinal (G,), lateral (G,)) normalized energy profiles."""
    e = img[..., 0]                                 # (B, X, Y, Z)
    longi = e.sum((1, 2)).mean(0)
    lat = e.sum((2, 3)).mean(0)
    return longi / (longi.sum() + 1e-9), lat / (lat.sum() + 1e-9)


def chi2_distance(p: np.ndarray, q: np.ndarray) -> float:
    return float(0.5 * np.sum((p - q) ** 2 / (p + q + 1e-9)))


def run(train_steps: int = 40, batch: int = 8, eval_events: int = 64,
        device="cuda") -> List[Tuple[str, float, str]]:
    """Rows ``(name, us per train step or 0, observation)``; ``device``
    defaults to the card and raises without one."""
    from repro_torch.serving.engine import resolve_device
    dev = resolve_device(device)
    cfg = G.GAN3DConfig(g_fc_ch=6, g_base=16, d_base=8)
    gp = G.init_generator(cfg, torch.Generator().manual_seed(0), dev)
    dp = G.init_discriminator(cfg, torch.Generator().manual_seed(1), dev)
    d_opt = optim.rmsprop(5e-4, clip_norm=1.0)
    g_opt = optim.rmsprop(1e-3, clip_norm=1.0)
    ds, gs = d_opt.init(dp), g_opt.init(gp)
    zgen = torch.Generator().manual_seed(2)

    def step(dp, ds, gp, gs, b, z):
        _, _, gd = value_and_grad(
            lambda p, a: G.d_loss(p, gp, cfg, a, z), dp, b)
        du, ds = d_opt.update(gd, ds, dp)
        dp = optim.apply_updates(dp, du)
        _, _, gg = value_and_grad(
            lambda p, a: G.g_loss(p, dp, cfg, a, z), gp, b)
        gu, gs = g_opt.update(gg, gs, gp)
        return dp, ds, optim.apply_updates(gp, gu), gs

    spec = CalorimeterSpec()
    t0 = time.perf_counter()
    for i in range(train_steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in generate_batch(spec, batch, i).items()}
        z = torch.randn(batch, cfg.latent_dim, generator=zgen).to(dev)
        dp, ds, gp, gs = step(dp, ds, gp, gs, b, z)
    float(gp["c4"]["b"][0])                         # waits for the last step
    train_s = time.perf_counter() - t0

    # ---- observables --------------------------------------------------------
    mc = generate_batch(spec, eval_events, step=10_000)
    z = torch.randn(eval_events, cfg.latent_dim, generator=zgen).to(dev)
    with torch.no_grad():
        fake = G.generator(gp, cfg, z, torch.from_numpy(mc["energies"]).to(
            dev)).cpu().numpy()

    longi_mc, lat_mc = profiles(mc["images"])
    longi_g, lat_g = profiles(fake)
    chi_l = chi2_distance(longi_mc, longi_g)
    chi_t = chi2_distance(lat_mc, lat_g)
    totals_g = fake.sum((1, 2, 3, 4))
    corr = float(np.corrcoef(mc["energies"], totals_g)[0, 1])
    peak_mc = int(np.argmax(longi_mc))
    peak_g = int(np.argmax(longi_g))

    return [
        ("physics/train", train_s * 1e6 / max(train_steps, 1),
         f"{train_steps} steps"),
        ("physics/longitudinal_chi2", 0.0,
         f"{chi_l:.4f} (0=perfect; <0.5 = qualitatively matching profile)"),
        ("physics/lateral_chi2", 0.0, f"{chi_t:.4f}"),
        ("physics/shower_max_depth", 0.0,
         f"MC z={peak_mc} vs GAN z={peak_g}"),
        ("physics/energy_response_corr", 0.0,
         f"{corr:.3f} (paper: conditioning on primary energy)"),
    ]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    for row in run(device=ap.parse_args().device):
        print(",".join(str(x) for x in row))
