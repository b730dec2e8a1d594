"""End-to-end LM training on the PyTorch port (the counterpart of
``examples/train_lm.py``): a ~100M-parameter dense model for a few hundred
steps.

The framework's "real training job": the synthetic token source ->
``stepfn.make_train_step`` under ``dp`` (``hvd.init``: world size 1
without ``torchrun``, NCCL on the card, gloo on the CPU; AdamW updating
in place) -> checkpoints with rotation (``repro_torch.checkpoint``, the
reference's layout, the 3 newest kept) and restart (``--resume``, from the
newest) -> metrics.  AdamW with ``warmup_cosine`` (warm-up a quarter of
the steps, at least 2 and at most 20), weight decay 0.01, global-norm
clipping at 1.0; weights from the port's ``init_params`` at seed 0.  The
run ends with the reference's verdict line, ``loss a -> b over N steps
(DOWN)``, and fails unless the loss went down.

Run (fast demo):     PYTHONPATH=src python examples/torch_train_lm.py --steps 30
Run (100M model):    PYTHONPATH=src python examples/torch_train_lm.py \\
                        --model 100m --steps 300 --seq-len 256 --batch 8
On the CPU:          PYTHONPATH=src python examples/torch_train_lm.py \\
                        --model tiny --steps 25 --seq-len 64 --device cpu

``--device`` defaults to ``cuda`` and fails without a card.  Checkpoints
go to ``--ckpt-dir`` (default ``repro_torch_lm_ckpt`` under the
temporary directory, ``$TMPDIR``).
"""
import argparse
import os
import tempfile
import time

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig

MODELS = {
    # ~100M dense LM (embed 20.5M + 10 x 6.5M layers)
    "100m": ModelConfig(
        name="repro-100m", family="dense", num_layers=10, d_model=640,
        num_heads=10, num_kv_heads=5, d_ff=2560, vocab_size=32_000,
        tie_embeddings=True),
    "20m": ModelConfig(
        name="repro-20m", family="dense", num_layers=6, d_model=320,
        num_heads=8, num_kv_heads=4, d_ff=1280, vocab_size=32_000,
        tie_embeddings=True),
    # small vocab => learnable within a CI-sized token budget
    "tiny": ModelConfig(
        name="repro-tiny", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=512,
        tie_embeddings=True),
    "smoke": get_smoke_config("qwen2-0.5b"),
}


def main(argv=None) -> dict:
    """Trains; returns the losses, the steps run (``start``, ``end``),
    tokens/s, the checkpoints written and, on a card, peak memory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="smoke", choices=sorted(MODELS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' trains on gloo)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import checkpoint as ck
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    cfg = MODELS[args.model]
    warmup = max(2, min(20, args.steps // 4))
    opt = optim.adamw(
        optim.schedules.warmup_cosine(args.lr, warmup, args.steps),
        weight_decay=0.01, clip_norm=1.0)

    with hvd.init(args.device) as device:
        groups = make_host_mesh()
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device, weight_dtype=torch.float32)
        n_params = sum(t.numel() for t in optim.leaves(params))
        print(f"model={cfg.name}  params={n_params/1e6:.1f}M  "
              f"device={device}  batch={args.batch}x{args.seq_len}")

        opt_state = opt.init(params)
        start = 0
        if args.resume and ck.latest_step(args.ckpt_dir) is not None:
            start = ck.latest_step(args.ckpt_dir)
            restored = ck.restore(args.ckpt_dir,
                                  {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            print(f"resumed from step {start}")

        step_fn = stepfn.make_train_step(cfg, opt, groups, strategy="dp",
                                         device=device)
        source = SyntheticTokenSource(TokenDatasetSpec(
            cfg.vocab_size, args.seq_len, args.batch))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        losses, saved, t0 = [], [], time.time()
        tokens_per_step = args.batch * args.seq_len
        for i in range(start, start + args.steps):
            params, opt_state, m = step_fn(params, opt_state,
                                           source.batch(i))
            losses.append(float(m["loss"]))
            if i % 10 == 0 or i == start + args.steps - 1:
                dt = time.time() - t0
                tps = tokens_per_step * (i - start + 1) / dt
                print(f"step {i:4d}  loss {losses[-1]:.4f}  ppl "
                      f"{float(m['perplexity']):.1f}  {tps:,.0f} tok/s")
            if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                p = ck.save(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt_state})
                saved.append(str(p))
                print(f"  checkpoint -> {p}")
        wall = time.time() - t0

        final = min(losses[-3:]) if len(losses) >= 3 else losses[-1]
        down = final < losses[0]
        print(f"\nloss {losses[0]:.4f} -> {final:.4f} over {args.steps} "
              f"steps ({'DOWN' if down else 'NOT DOWN'})")
        result = {"model": cfg.name, "params": n_params, "losses": losses,
                  "start": start, "end": start + args.steps,
                  "tokens_per_s": tokens_per_step * args.steps / wall,
                  "checkpoints": saved, "device": str(device)}
        if device.type == "cuda":
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
    if not down:
        raise AssertionError("training failed to reduce loss")
    return result


if __name__ == "__main__":
    main()
