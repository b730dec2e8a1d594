#!/usr/bin/env python3
"""Loss curves of a full-width config cut in depth, trained on the card
under the strategies and learning rates given: the step
``chip_smoke.py`` phase 21 drives (``stepfn.make_train_step`` on
``launch.mesh.make_host_mesh``'s (1, 1) groups, AdamW with clipping at
1.0, weights from ``init_params`` at seed 0 drawn on the card, f32
masters, B 2 x S 2,048 of the synthetic token source).  Prints, for each
(strategy, lr), the losses, the MoE aux losses, the step ms (mean of
steps 1 on) and the peak device memory, with the card's name and power
limit.

    python scripts/torch_sharded_probe.py --arch deepseek-coder-33b \\
        --layers 4 --strategy dp fsdp_tp --lr 3e-4 1e-4
    python scripts/torch_sharded_probe.py --arch qwen3-moe-30b-a3b \\
        --layers 4 --strategy fsdp_tp --lr 1e-4 5e-5

Needs a card (it refuses to run without one).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--strategy", nargs="+", default=["fsdp_tp"],
                    choices=["dp", "dp_tp", "fsdp_tp"])
    ap.add_argument("--lr", nargs="+", type=float, default=[1e-4])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_sharded_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import family_batch
    from repro_torch.models import transformer as T

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = get_config(args.arch).with_(num_layers=args.layers)
    src = SyntheticTokenSource(TokenDatasetSpec(
        cfg.vocab_size, args.seq_len, args.global_batch))
    for strategy in args.strategy:
        for lr in args.lr:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            res = {"arch": cfg.name, "layers": args.layers,
                   "strategy": strategy, "lr": lr, "losses": [],
                   "aux_losses": [], "step_s": []}
            with hvd.init("cuda") as device:
                groups = make_host_mesh()
                params = T.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev, weight_dtype=torch.float32)
                opt = optim.adamw(lr, clip_norm=1.0)
                if strategy == "dp":
                    state = opt.init(params)
                else:
                    params, state = stepfn.shard_state(params, cfg, opt,
                                                       strategy, groups)
                step = stepfn.make_train_step(cfg, opt, groups,
                                              strategy=strategy,
                                              device=device)
                for i in range(args.steps):
                    batch = family_batch(cfg, src.batch(i), i)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, state, m = step(params, state, batch)
                    res["losses"].append(float(m["loss"]))
                    res["step_s"].append(time.perf_counter() - t0)
                    res["aux_losses"].append(float(m["aux_loss"]))
                del params, state, step
            steady = res["step_s"][1:] or res["step_s"]
            res["step_ms"] = sum(steady) / len(steady) * 1e3
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                dev)
            res["device"] = torch.cuda.get_device_name(dev)
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
