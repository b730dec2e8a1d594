#!/usr/bin/env python3
"""The dry-run's attribution of the memory levers on the ``train_4k``
pairs that exceed one card at the production layout.

For each pair the port's dry-run (``repro_torch.launch.dryrun.
count_step``: one rank of the (16, 16) ``(data, model)`` layout on meta
tensors, no device) counts the train step four ways, as the reference's
hill-climb passes ``step_kw`` to ``make_train_step``:

- ``plain``: the step as the dry-run sweep counts it;
- ``chunked_ce``: the chunked vocab-parallel cross-entropy
  (``seq_chunk`` 512, no (B, S, V) logits);
- ``microbatches 2``: the rank's rows in two halves, gradients
  accumulated in f32;
- ``dots``: ``remat_policy="dots"`` (the products' outputs saved).

Prints one JSON line per (pair, variant) with the peak per rank and
where it is reached (``peak_at``), the arguments, FLOPs and collective
bytes, then a table of the peaks in GB.

  PYTHONPATH=src python scripts/torch_dryrun_levers.py [--arch ARCH ...]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PAIRS = ("deepseek-coder-33b", "qwen2-vl-72b", "zamba2-1.2b")
VARIANTS = {"plain": ({}, {}),
            "chunked_ce": ({}, {"loss_variant": "chunked_ce",
                                "seq_chunk": 512}),
            "microbatches 2": ({}, {"microbatches": 2}),
            "dots": ({"remat_policy": "dots"}, {})}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append", choices=PAIRS)
    args = ap.parse_args(argv)

    from repro_torch.configs import default_strategy, get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh

    mesh = production_mesh().shape
    shape = SHAPES["train_4k"]
    rows = []
    for arch in args.arch or PAIRS:
        base = get_config(arch)
        strategy = default_strategy(base)
        for name, (cfg_kw, step_kw) in VARIANTS.items():
            rec = dryrun.count_step(base.with_(**cfg_kw), shape, strategy,
                                    mesh, **step_kw)
            row = {"arch": arch, "strategy": strategy, "variant": name,
                   "mesh": mesh, **{k: rec[k] for k in (
                       "peak_memory_per_device", "peak_at",
                       "argument_size", "temp_size", "flops",
                       "collective_bytes_total", "fits", "trace_s")}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print("\narch | strategy | " + " | ".join(VARIANTS) + "  (peak GB a rank)")
    for arch in args.arch or PAIRS:
        mine = [r for r in rows if r["arch"] == arch]
        print(f"{arch} | {mine[0]['strategy']} | " + " | ".join(
            f"{r['peak_memory_per_device'] / 1e9:.2f}" for r in mine))
    return rows


if __name__ == "__main__":
    main()
