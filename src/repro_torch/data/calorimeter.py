"""Synthetic CLIC calorimeter shower generator (the 3DGAN training data;
the port's own copy of ``repro.data.calorimeter``, numpy only: for each
``(seed, step, rank)`` it gives the reference's arrays bit for bit).

The paper's dataset: electromagnetic showers in a 25x25x25-cell LCD
calorimeter grid, one electron per event, conditioned on the primary
particle energy [21-24].  We generate physically-shaped synthetic events:
a longitudinal gamma-like energy-deposition profile along z with lateral
Gaussian spread (Moliere-radius-style), total deposition proportional to
the primary energy — enough structure for the GAN losses, the energy
regressor and the physics-validation benchmark to be meaningful.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class CalorimeterSpec:
    grid: int = 25
    e_min: float = 10.0      # GeV
    e_max: float = 500.0
    seed: int = 0


def generate_batch(spec: CalorimeterSpec, batch: int, step: int = 0,
                   rank: int = 0) -> Dict[str, np.ndarray]:
    """Returns {"images": (B, G, G, G, 1) f32, "energies": (B,) f32}."""
    rng = np.random.default_rng((spec.seed, step, rank))
    G = spec.grid
    e = rng.uniform(spec.e_min, spec.e_max, batch).astype(np.float32)

    z = np.arange(G, dtype=np.float32)
    # longitudinal gamma profile: t^a * exp(-b t); shower max scales ~ log E
    a = 2.0 + 0.5 * np.log(e / 10.0)[:, None]
    b = 0.5
    prof = np.power(z[None] + 0.5, a) * np.exp(-b * z[None])     # (B, G)
    prof /= prof.sum(axis=1, keepdims=True)

    xy = np.arange(G, dtype=np.float32) - (G - 1) / 2
    # lateral spread narrows with depth-weighted core + halo
    sigma = rng.uniform(1.2, 1.8, batch).astype(np.float32)[:, None]
    lat = np.exp(-0.5 * (xy[None] / sigma) ** 2)                 # (B, G)
    lat /= lat.sum(axis=1, keepdims=True)

    img = (e[:, None, None, None]
           * lat[:, :, None, None] * lat[:, None, :, None] * prof[:, None, None, :])
    # cell-level fluctuation + sparsification (calorimeter noise floor)
    img = img * rng.gamma(4.0, 0.25, img.shape).astype(np.float32)
    img[img < 1e-4] = 0.0
    return {"images": img[..., None].astype(np.float32), "energies": e}


class CalorimeterSource:
    """Each rank's shard of a global batch: ``batch // world_size`` events
    a step, drawn from the rank's own stream."""

    def __init__(self, spec: CalorimeterSpec, batch: int, rank: int = 0,
                 world_size: int = 1):
        if batch % world_size != 0:
            raise ValueError(f"batch {batch} is not a multiple of world_size "
                             f"{world_size}")
        self.spec = spec
        self.local_batch = batch // world_size
        self.rank = rank

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return generate_batch(self.spec, self.local_batch, step, self.rank)
