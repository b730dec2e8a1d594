"""Sharded on-disk dataset format (the paper's CLIC-HDF5-on-GPFS analogue;
the port's own copy of ``repro.data.shards``: a dataset written by either
package reads in the other with identical batches).

The paper's 3DGAN reads electron-shower events from HDF5 shards on the
GPFS parallel filesystem; each MPI rank reads its own subset.  This module
implements the same contract with an npz-based shard format:

  dataset_dir/
      index.json        (shard list, per-shard counts, schema, fingerprint)
      shard_00000.npz   (columnar arrays)
      ...

* ``write_dataset`` streams batches from any generator into fixed-size
  shards with a fingerprinted index (atomic rename, like the checkpoints).
* ``ShardedDataset`` gives each rank a disjoint shard subset
  (round-robin, the paper's one-rank-per-node layout), per-epoch shard
  shuffling with a seeded rng, and batched iteration with wraparound.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


def write_dataset(out_dir: Path, batches: Iterator[Dict[str, np.ndarray]],
                  *, events_per_shard: int = 1024,
                  max_events: Optional[int] = None) -> Path:
    out_dir = Path(out_dir)
    tmp = out_dir.with_name(out_dir.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)

    buf: Dict[str, List[np.ndarray]] = {}
    shards = []
    total = 0

    def flush():
        nonlocal buf
        if not buf:
            return
        arrays = {k: np.concatenate(v) for k, v in buf.items()}
        n = len(next(iter(arrays.values())))
        name = f"shard_{len(shards):05d}.npz"
        np.savez(tmp / name, **arrays)
        digest = hashlib.sha256((tmp / name).read_bytes()).hexdigest()[:16]
        shards.append({"file": name, "events": n, "sha256_16": digest})
        buf = {}

    for batch in batches:
        n = len(next(iter(batch.values())))
        for k, v in batch.items():
            buf.setdefault(k, []).append(np.asarray(v))
        total += n
        if sum(len(a) for a in buf[next(iter(buf))]) >= events_per_shard:
            flush()
        if max_events and total >= max_events:
            break
    flush()

    schema = {}
    if shards:
        probe = np.load(tmp / shards[0]["file"])
        schema = {k: {"shape": list(probe[k].shape[1:]),
                      "dtype": str(probe[k].dtype)} for k in probe.files}
    index = {"version": 1, "total_events": total, "shards": shards,
             "schema": schema}
    (tmp / "index.json").write_text(json.dumps(index, indent=2))
    if out_dir.exists():
        import shutil
        shutil.rmtree(out_dir)
    os.rename(tmp, out_dir)
    return out_dir


class ShardedDataset:
    """Per-rank reader over a written dataset."""

    def __init__(self, path: Path, rank: int = 0, world_size: int = 1,
                 seed: int = 0):
        self.path = Path(path)
        self.index = json.loads((self.path / "index.json").read_text())
        self.rank, self.world_size, self.seed = rank, world_size, seed
        self.my_shards = [s for i, s in enumerate(self.index["shards"])
                          if i % world_size == rank]
        if not self.my_shards:
            raise ValueError(f"rank {rank}: no shards "
                             f"({len(self.index['shards'])} total)")

    @property
    def local_events(self) -> int:
        return sum(s["events"] for s in self.my_shards)

    def verify(self) -> bool:
        for s in self.my_shards:
            digest = hashlib.sha256(
                (self.path / s["file"]).read_bytes()).hexdigest()[:16]
            if digest != s["sha256_16"]:
                raise IOError(f"shard {s['file']} corrupt "
                              f"({digest} != {s['sha256_16']})")
        return True

    def _load(self, shard) -> Dict[str, np.ndarray]:
        with np.load(self.path / shard["file"]) as z:
            return {k: z[k] for k in z.files}

    def epoch(self, epoch: int, batch_size: int) \
            -> Iterator[Dict[str, np.ndarray]]:
        """Batched iteration over this rank's shards (seeded shuffle)."""
        rng = np.random.default_rng((self.seed, epoch, self.rank))
        order = rng.permutation(len(self.my_shards))
        carry: Dict[str, List[np.ndarray]] = {}
        carried = 0
        for si in order:
            data = self._load(self.my_shards[si])
            perm = rng.permutation(len(next(iter(data.values()))))
            data = {k: v[perm] for k, v in data.items()}
            for k, v in data.items():
                carry.setdefault(k, []).append(v)
            carried += len(perm)
            while carried >= batch_size:
                merged = {k: np.concatenate(v) for k, v in carry.items()}
                yield {k: v[:batch_size] for k, v in merged.items()}
                carry = {k: [v[batch_size:]] for k, v in merged.items()}
                carried -= batch_size
