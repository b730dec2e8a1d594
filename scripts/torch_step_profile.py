#!/usr/bin/env python3
"""Where one full-width training step of the PyTorch port spends the card.

    python scripts/torch_step_profile.py [--src DIR] [--arch qwen2-0.5b]

Two unprofiled steps, then one under ``torch.profiler`` (seq 1024, batch 8,
AdamW over f32 masters, the launcher's ``dp`` step at world size 1 with its
gradient all_reduce: ``chip_smoke.profile_train_step``); prints the
card's name and power limit, then one JSON line with the device time by
kernel family.  ``--src`` names the ``src`` directory whose ``repro_torch``
runs (default: this checkout's), so that two trees compare on one card:
unpack the other with ``git archive`` into a git-ignored directory and run
them in the order a, b, b, a.  Its ``stepfn.make_train_step`` must take
the data group (``make_train_step(cfg, optimizer, groups, ...)``), as
this checkout's does.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="qwen2-0.5b")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    out = chip_smoke.profile_train_step(torch, get_config(args.arch),
                                        torch.device("cuda"))
    print(json.dumps({"src": str(src), "arch": args.arch, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
