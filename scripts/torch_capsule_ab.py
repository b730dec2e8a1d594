#!/usr/bin/env python3
"""The LM launcher bare and inside the capsule, in turns, on one card.

The paper's claim (Tables 2-3) is that the container costs nothing
measurable.  This runs ``repro_torch.launch.train.main`` at full width
(qwen2-0.5b, ``--strategy dp``, seq 1024, batch 8, 8 AdamW steps, NCCL at
world size 1) bare and inside ``Deployment.run`` of the PyTorch image, in
the order bare, capsule, capsule, bare (``--pairs`` times), all in one
process, and prints each run's mean step time over steps 1-7, tokens/s and
peak device memory, then each mode's median and the spread of its runs.
The image is deployed under the git-ignored ``build/capsule_ab``.

  python scripts/torch_capsule_ab.py [--pairs 2] [--arch qwen2-0.5b]
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import deploy as D
    from repro_torch.launch import train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    work = ROOT / "build" / "capsule_ab"
    shutil.rmtree(work, ignore_errors=True)
    dep = D.DeploymentPipeline().deploy(D.pytorch_image("capsule-ab"), work)
    launcher = ["--arch", args.arch, "--strategy", "dp", "--seq-len", "1024",
                "--global-batch", "8", "--steps", str(args.steps)]
    runs = {"bare": [], "capsule": []}
    for mode in ["bare", "capsule", "capsule", "bare"] * args.pairs:
        if mode == "bare":
            run = train.main(launcher)
        else:
            run = dep.run(train.main, launcher)[0].value
        del run["params"]
        steady = run["step_s"][1:]
        r = {"mode": mode, "step_ms": 1e3 * sum(steady) / len(steady),
             "tokens_per_s": run["tokens_per_s"],
             "peak_gib": run["max_memory_allocated"] / 2**30,
             "losses": run["losses"]}
        print(json.dumps(r), flush=True)
        runs[mode].append(r)
        torch.cuda.empty_cache()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for mode, rs in runs.items():
        ms = [r["step_ms"] for r in rs]
        out[mode] = {"median_step_ms": statistics.median(ms),
                     "min_step_ms": min(ms), "max_step_ms": max(ms),
                     "peak_gib": max(r["peak_gib"] for r in rs)}
    out["capsule_over_bare_pct"] = 100 * (
        out["capsule"]["median_step_ms"] / out["bare"]["median_step_ms"] - 1)
    out["losses_equal"] = all(r["losses"] == runs["bare"][0]["losses"]
                              for rs in runs.values() for r in rs)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
