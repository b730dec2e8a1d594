#!/usr/bin/env python3
"""The ``dp`` loss of deepseek-coder-33b cut in depth and width at AdamW
lr 3e-4, on the card and against the reference.

At lr 3e-4 the port's loss of deepseek-coder-33b cut to 4 layers rises
over 8 steps on the card (``scripts/torch_sharded_probe.py``).  Two
modes:

``--card`` (needs a card, imports no JAX): the port's ``dp`` step
(``stepfn.make_train_step`` at world size 1, AdamW with clipping at 1.0,
f32 masters, B 2 x S 2,048 of the synthetic token source) for 8 steps at
each cut of ``CUTS``: the layers at full width, then the width divided
by 2, 4 and 8 with deepseek-coder-33b's ratios kept (head dim 128, 7
query heads a KV head, d_ff / d_model 19,200 / 7,168; the vocabulary of
32,256 kept).  The weights come from the port's ``init_params`` at seed
0 drawn by a CPU generator, so that ``--cpu`` draws the same ones.
Prints each cut's losses, whether the last is above the first, its step
ms and peak, with the card's name and power limit.  ``--dtypes`` runs
each cut in each compute dtype listed (the config's ``dtype``; the f32
masters, the weights and the batches are the same): ``float32`` tells
the optimizer's dynamics from the bf16 forward's rounding.

``--cpu`` (both packages, on the CPU): at one cut (``--layers``,
``--width``), the reference's ``dp`` step (``repro.distributed.stepfn.
make_train_step`` on the host mesh) on the same weights (bridged) and
batches, and the port's ``dp`` step on gloo, each for 8 steps in the
config's bf16; prints both curves and each step's relative gap.  With
``--card-losses`` (a JSON list, the ``--card`` run's curve at that cut)
it prints that curve's gaps to the reference's too.

  python scripts/torch_loss_rise.py --card
  python scripts/torch_loss_rise.py --card --cuts '[[3, 1]]' \
      --dtypes bfloat16,float32
  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_loss_rise.py \\
      --cpu --layers 1 --width 4 [--card-losses '[...]']
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "deepseek-coder-33b"
LR, STEPS, SEQ, BATCH = 3e-4, 8, 2048, 2
# (layers, width divisor): depth first at full width, then width at 1
# layer
CUTS = ((4, 1), (2, 1), (1, 1), (1, 2), (1, 4), (1, 8))


def cut_config(get_config, layers: int, width: int):
    """deepseek-coder-33b at ``layers`` layers with d_model, d_ff and the
    head counts divided by ``width`` (head dim and the GQA ratio kept)."""
    base = get_config(ARCH)
    return base.with_(num_layers=layers, d_model=base.d_model // width,
                      num_heads=base.num_heads // width,
                      num_kv_heads=base.num_kv_heads // width,
                      d_ff=base.d_ff // width)


def port_curve(cfg, device: str) -> dict:
    """The port's dp step for ``STEPS`` steps on ``device``: losses, step
    seconds, peak (on a card)."""
    import torch

    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, SEQ, BATCH))
    res = {"losses": [], "step_s": []}
    with hvd.init(device) as dev:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        groups = make_host_mesh()
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev, weight_dtype=torch.float32)
        opt = optim.adamw(LR, clip_norm=1.0)
        state = opt.init(params)
        step = stepfn.make_train_step(cfg, opt, groups, strategy="dp",
                                      device=dev)
        for i in range(STEPS):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, src.batch(i))
            res["losses"].append(float(m["loss"]))
            res["step_s"].append(time.perf_counter() - t0)
        if dev.type == "cuda":
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                dev)
    return res


def card(argv_cuts, dtypes) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_loss_rise: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for (layers, width), dtype in ((c, d) for c in argv_cuts
                                   for d in dtypes):
        cfg = cut_config(get_config, layers, width).with_(dtype=dtype)
        res = port_curve(cfg, "cuda")
        steady = res["step_s"][1:]
        print(json.dumps({
            "arch": ARCH, "layers": layers, "width_divisor": width,
            "dtype": dtype,
            "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                              cfg.num_kv_heads],
            "d_ff": cfg.d_ff, "params": cfg.param_count(), "lr": LR,
            "losses": res["losses"],
            "rises": res["losses"][-1] > res["losses"][0],
            "step_ms": sum(steady) / len(steady) * 1e3,
            "max_memory_allocated": res["max_memory_allocated"],
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def reference_curve(layers: int, width: int, flat) -> list:
    """The reference's dp step on the CPU for ``STEPS`` steps from the
    bridged weights ``flat`` (``bridge.to_flat``)."""
    import jax
    import jax.numpy as jnp

    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro.distributed import stepfn
    from repro.launch.mesh import make_host_mesh

    cfg = cut_config(get_config, layers, width)
    params = {}
    for key, v in flat.items():
        node = params
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    opt = optim.adamw(LR, clip_norm=1.0)
    step, _, _ = stepfn.make_train_step(
        cfg, opt, make_host_mesh(), "dp",
        InputShape("train", SEQ, BATCH, "train"))
    state = opt.init(params)
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, SEQ, BATCH))
    losses = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(jax.device_get(m["loss"])))
    return losses


def cpu(layers: int, width: int, card_losses) -> int:
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = cut_config(get_config, layers, width)
    flat = bridge.to_flat(T.init_params(
        cfg, torch.Generator().manual_seed(0), weight_dtype=torch.float32))
    t0 = time.perf_counter()
    ref = reference_curve(layers, width, flat)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = port_curve(cfg, "cpu")["losses"]
    t_port = time.perf_counter() - t0

    def gaps(xs):
        return [abs(a - b) / abs(b) for a, b in zip(xs, ref)]
    out = {"arch": ARCH, "layers": layers, "width_divisor": width,
           "d_model": cfg.d_model, "lr": LR, "reference_cpu": ref,
           "port_cpu": port, "port_cpu_gap": gaps(port),
           "reference_rises": ref[-1] > ref[0], "port_rises": port[-1] > port[0],
           "seconds": [t_ref, t_port]}
    if card_losses is not None:
        out["port_card"] = card_losses
        out["port_card_gap"] = gaps(card_losses)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true")
    mode.add_argument("--cpu", action="store_true")
    ap.add_argument("--cuts", default=None,
                    help="JSON list of [layers, width divisor] (--card; "
                         "default CUTS)")
    ap.add_argument("--dtypes", default="bfloat16",
                    help="comma-separated compute dtypes (--card)")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--width", type=int, default=1)
    ap.add_argument("--card-losses", default=None)
    args = ap.parse_args(argv)
    if args.card:
        cuts = json.loads(args.cuts) if args.cuts else CUTS
        return card([tuple(c) for c in cuts], args.dtypes.split(","))
    return cpu(args.layers, args.width,
               json.loads(args.card_losses) if args.card_losses else None)


if __name__ == "__main__":
    sys.exit(main())
