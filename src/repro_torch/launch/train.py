"""Training launcher for the PyTorch port (counterpart of
``repro.launch.train``).

In-capsule entrypoint: the Slurm script that ``repro_torch.launch.slurm``
renders runs ``ch-run <image> -- python -m repro_torch.launch.train
--arch <id> ...`` on every rank.  The reference's flags, plus ``--device``,
``--dtype`` and ``--init-method``: random weights from the port's
``init_params`` at seed 0 on the device's generator (on the card a layer
slice at a time: the host's generator took ~27 s to draw gemma2-2b's
2.66 B f32 leaves whole) held as f32 masters (broadcast from rank 0, as
Horovod's recipe does), the synthetic Markov token source, the chosen
optimizer with global-norm clipping at 1.0, and the strategy's step
(``distributed.stepfn.make_train_step``) at every world size, inside
``hvd.init`` (NCCL on the card, gloo on the CPU; world size 1 without
``torchrun``).  ``--strategy`` defaults as the reference's does: ``dp``
with ``--smoke``, else ``configs.default_strategy`` (``dp_tp`` under 20 B
parameters, ``fsdp_tp`` from 20 B).  The mesh is the reference's host
mesh, every rank over ``data``, with a ``model`` axis of size 1
(``launch.mesh.make_host_mesh``): the reference's has no ``model`` axis,
so its launcher stops with ``KeyError: 'model'`` under ``dp_tp`` and
``fsdp_tp``.  ``dp``: each rank takes its rows of the global batch and
the gradients are averaged by ``hvd.allreduce``.  ``dp_tp`` /
``fsdp_tp``: the params and AdamW state are cut into this rank's shards
(``stepfn.shard_state``), the model runs tensor-parallel over ``model``
and, under ``fsdp_tp``, gathers each layer group over ``data`` (a larger
``model`` axis is ``stepfn.make_train_step`` on ``launch.mesh.make_mesh``;
the launcher adds no flag the reference lacks).  Rank 0 prints the
reference's step and summary lines, then step time, tokens/s, each
kernel's launches per step, the data and model groups' collectives (calls
and bytes) per step and, on the card, peak device memory.  Every family
trains.

The encdec and vlm batches follow the reference's ``input_specs``
(``configs.base``): the stub frontend's inputs come from
``synthesize_inputs`` with a generator seeded by the step.  encdec, as
the reference's launcher: its frames (B, 1500, d), with the source's
tokens and labels.  vlm: patch embeddings (B, num_patches, d) and M-RoPE
positions (3, B, S); the text is the source's first S - num_patches
tokens and the labels are the text behind num_patches unread places (the
loss drops the patch positions).  The reference's launcher overwrites
the vlm text with the source's (B, S) tokens and then fails on the
positions' shape (ROADMAP Queue 3).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --seq-len 1024 --global-batch 8 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --seq-len 1024 --global-batch 8 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --seq-len 448 --global-batch 8 --steps 8
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --smoke --strategy dp --device cpu --steps 4

``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain PyTorch versions.  ``--ckpt-dir`` saves
whole leaves: under ``fsdp_tp`` every rank gathers them
(``sharding.unshard``) and rank 0 writes them.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--strategy", default=None,
                    choices=["dp", "dp_tp", "fsdp_tp"],
                    help="default: dp with --smoke, else the config's "
                         "default_strategy")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8,
                    help="global batch (split over the ranks)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adam", "rmsprop", "sgd"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="rank 0 saves params and optimizer state here")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, NCCL; 'cpu' runs the "
                         "kernels' plain PyTorch versions on gloo)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="compute dtype (default: the config's)")
    ap.add_argument("--init-method", default=None,
                    help="the process group's store (default env:// under "
                         "torchrun, a private file:// store alone)")
    return ap


def family_batch(cfg, batch: dict, step: int) -> dict:
    """The training batch of ``cfg``'s family at ``step``: the token
    source's ``batch`` as it is, or with the encdec / vlm frontend's
    inputs (see the module's docstring)."""
    if cfg.family not in ("encdec", "vlm"):
        return batch
    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape, synthesize_inputs
    B, S = batch["tokens"].shape
    shape = InputShape("cli-train", S, B, "train")
    extra = synthesize_inputs(cfg, shape,
                              torch.Generator().manual_seed(step))
    if cfg.family == "encdec":
        return dict(extra, tokens=batch["tokens"], labels=batch["labels"])
    P = cfg.num_patches
    text = np.ascontiguousarray(batch["tokens"][:, :S - P])
    labels = np.concatenate([np.zeros((B, P), np.int32), text], axis=1)
    return dict(extra, tokens=text, labels=labels)


def main(argv=None) -> dict:
    """Runs the training loop; returns the run's numbers (losses, step
    seconds, tokens/s, ``launches_per_step``: {kernel: [launches in each
    step]}, ``collectives_per_step`` / ``model_collectives_per_step``:
    the calls and bytes this rank handed the data / model group in each
    step, peak memory on a card) and its final ``params`` (this rank's
    shards under ``dp_tp`` / ``fsdp_tp``)."""
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ck
    from repro_torch import optim
    from repro_torch.configs import (default_strategy, get_config,
                                     get_smoke_config)
    from repro_torch.distributed import sharding as sh
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    T.check_trainable(cfg)                       # before any process group
    strategy = args.strategy or ("dp" if args.smoke
                                 else default_strategy(cfg))
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype)
    with hvd.init(args.device, init_method=args.init_method) as device:
        world_size, rank = dist.get_world_size(), dist.get_rank()
        groups = make_host_mesh()
        lead = rank == 0
        opt = optim.get(args.optimizer, args.lr, clip_norm=1.0)
        if lead:
            print(f"arch={cfg.name} family={cfg.family} "
                  f"strategy={strategy} device={device} "
                  f"world_size={world_size} backend={dist.get_backend()} "
                  f"mesh={groups.shape} "
                  f"params~{cfg.param_count()/1e6:.1f}M")

        params = hvd.broadcast(
            T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                          device=device, weight_dtype=torch.float32),
            groups.world)
        pspec = ospec = None
        if strategy == "dp":
            opt_state = opt.init(params)
        else:
            pspec, ospec = stepfn.state_specs(cfg, opt, strategy, groups)
            params, opt_state = stepfn.shard_state(params, cfg, opt,
                                                   strategy, groups)
        step_fn = stepfn.make_train_step(cfg, opt, groups,
                                         strategy=strategy, device=device)
        source = SyntheticTokenSource(TokenDatasetSpec(
            cfg.vocab_size, args.seq_len, args.global_batch))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        counters = {"flash_attention": fa.flash_attention,
                    "ssd_scan": ssd.ssd_scan, "rmsnorm": rn.rmsnorm}
        losses, step_s, per_step, model_per_step = [], [], [], []
        launches = {k: [] for k in counters}
        t0 = time.time()
        for i in range(args.steps):
            # the batch (for encdec and vlm, the stub frontend's inputs
            # drawn on the host) is made before the step's clock starts
            batch = family_batch(cfg, source.batch(i), i)
            t_step = time.perf_counter()
            n0 = {k: f.launches for k, f in counters.items()}
            groups.reset_counts()
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])             # waits for the step
            step_s.append(time.perf_counter() - t_step)
            counts = groups.counts()
            calls, nbytes = counts[("data",)]
            per_step.append({"calls": calls, "bytes": nbytes})
            calls, nbytes = counts[("model",)]
            model_per_step.append({"calls": calls, "bytes": nbytes})
            for k, f in counters.items():
                launches[k].append(f.launches - n0[k])
            losses.append(loss)
            if lead and (i % 5 == 0 or i == args.steps - 1):
                print(f"step {i:4d}  loss {loss:.4f}")
            if (args.ckpt_dir and args.ckpt_every
                    and (i + 1) % args.ckpt_every == 0):
                tree = {"params": params, "opt": opt_state}
                if pspec is not None:           # every rank gathers
                    tree = sh.unshard(tree, {"params": pspec, "opt": ospec},
                                      groups)
                if lead:
                    ck.save(args.ckpt_dir, i + 1, tree)
                del tree

        tokens = args.global_batch * args.seq_len
        steady = step_s[1:] or step_s           # step 0 pays the kernel build
        mean_s = sum(steady) / len(steady)
        result = {"arch": cfg.name, "device": str(device),
                  "world_size": world_size, "backend": dist.get_backend(),
                  "strategy": strategy, "mesh": groups.shape,
                  "losses": losses, "step_s": step_s,
                  "tokens_per_step": tokens, "tokens_per_s": tokens / mean_s,
                  "launches_per_step": launches,
                  "collectives_per_step": per_step,
                  "model_collectives_per_step": model_per_step,
                  "params": params}
        if lead:
            print(f"{args.steps} steps in {time.time()-t0:.1f}s; "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
            print(f"step time {mean_s * 1e3:.1f} ms (mean of steps "
                  f"{1 if len(step_s) > 1 else 0}-{len(step_s) - 1}); "
                  f"{result['tokens_per_s']:.0f} tokens/s; kernel launches "
                  f"per step {launches}; data-group collectives per step "
                  f"{per_step[-1]}; model-group collectives per step "
                  f"{model_per_step[-1]}")
        if device.type == "cuda":
            result["device_name"] = torch.cuda.get_device_name(device)
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
            if lead:
                print(f"peak device memory "
                      f"{result['max_memory_allocated'] / 2**30:.2f} GiB on "
                      f"{result['device_name']}")
    return result


if __name__ == "__main__":
    main()
