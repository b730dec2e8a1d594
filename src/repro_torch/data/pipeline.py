"""Synthetic token data (the port's copy of ``repro.data.pipeline``'s
numpy sources).

A noisy first-order Markov chain over the vocabulary, so the loss is
learnable: each next token follows a fixed random permutation of the
current one, or with probability ``noise`` is uniform.  Batches are numpy,
deterministic per ``(seed, epoch, step, rank)``, and identical bit for bit
to the reference's, so a restart replays the same data.  Every rank reads
only its shard (``local_batch = global_batch // world_size``).  The
reference's ``ShardedLoader`` places batches on a JAX mesh and has no
counterpart here: the train step moves each batch to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class TokenDatasetSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    noise: float = 0.3


class SyntheticTokenSource:
    """Deterministic synthetic token stream with learnable structure."""

    def __init__(self, spec: TokenDatasetSpec, rank: int = 0,
                 world_size: int = 1):
        if spec.global_batch % world_size != 0:
            raise ValueError(f"global_batch {spec.global_batch} is not a "
                             f"multiple of world_size {world_size}")
        self.spec = spec
        self.rank = rank
        self.world_size = world_size
        self.local_batch = spec.global_batch // world_size
        rng = np.random.default_rng(spec.seed)
        self._table = rng.permutation(spec.vocab_size)   # next ~ P[cur]

    def batch(self, step: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.spec.seed, epoch, step, self.rank))
        B, S, V = self.local_batch, self.spec.seq_len, self.spec.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        for t in range(1, S):
            follow = self._table[toks[:, t - 1]]
            noise = rng.integers(0, V, B)
            toks[:, t] = np.where(rng.random(B) < self.spec.noise,
                                  noise, follow)
        return {"tokens": toks, "labels": toks.copy()}
