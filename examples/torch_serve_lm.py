"""Batched serving example on the PyTorch port (the counterpart of
``examples/serve_lm.py``): the continuous-batching scheduler over the
engine's captured round programs (``repro_torch/serving/``), on the arch's
smoke variant with random weights from the port's ``init_params`` at
seed 0.

Two modes:

* default — a burst of independent random-prompt requests (continuous
  batching demo), sampled at temperature 0.8;
* ``--chat`` — a multi-turn conversation replaying a shared system
  prompt: every turn's prompt is system + history + new user tokens, so
  the prefix cache serves the conversation so far from its KV store and
  only the new tail runs through prefill.  Prints per-turn recompute
  counts and the final hit rate.

The engine runs paged KV wherever the family's cache is positional (dense,
moe, vlm: on the card the paged prefill and paged decode kernels), and
dense per-slot caches for the ssm and hybrid families, which serve dense
only; the reference's example serves every family dense.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-2b
      PYTHONPATH=src python examples/torch_serve_lm.py --chat --turns 6
      PYTHONPATH=src python examples/torch_serve_lm.py --chat --device cpu

``--device`` defaults to ``cuda`` and fails without a card.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_smoke_config


def run_burst(engine, cfg, args) -> dict:
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, rng.integers(4, 12),
                                 dtype=np.int32).astype(np.int32),
                    SamplingParams(max_new_tokens=args.max_new,
                                   temperature=0.8))
            for _ in range(args.slots)]
    print(f"batch={len(reqs)} requests")
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"  req {i}: prompt_len={len(reqs[i].prompt)} -> {o.tolist()}")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s batched decode)")
    return {"outputs": [o.tolist() for o in outs],
            "tokens_per_s": total_new / dt}


def run_chat(engine, cfg, args) -> dict:
    """Multi-turn chat against one engine: shared system prompt + growing
    history, each turn admitted as a full independent prompt — exactly the
    traffic shape the prefix cache exists for."""
    from repro_torch.serving import Request, SamplingParams, Scheduler
    rng = np.random.default_rng(0)
    sched = Scheduler(engine)
    system = rng.integers(0, cfg.vocab_size, args.system_len,
                          dtype=np.int32)
    history = system
    print(f"chat: {args.turns} turns over a shared {len(system)}-token "
          f"system prompt (prefix cache "
          f"{'on' if engine.prefix_cache else 'off'})")
    turns = []
    for turn in range(args.turns):
        user = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 9)),
                            dtype=np.int32)
        prompt = np.concatenate([history, user])
        before = engine.prefill_tokens
        rid = sched.submit(Request(prompt, SamplingParams(
            max_new_tokens=args.max_new, greedy=True)))
        sched.run()
        reply = sched.output(rid)
        ttft_ms = (sched.metrics._first[rid]
                   - sched.metrics._submit[rid]) * 1e3
        recomputed = engine.prefill_tokens - before
        print(f"  turn {turn}: prompt {len(prompt):4d} tok, "
              f"recomputed {recomputed:3d}, "
              f"ttft {ttft_ms:6.1f} ms -> {reply.tolist()}")
        turns.append({"prompt": len(prompt), "recomputed": recomputed,
                      "ttft_ms": ttft_ms, "reply": reply.tolist()})
        history = np.concatenate([prompt, reply])
    pc = sched.metrics.summary()["prefix_cache"]
    print(f"prefix cache: hit rate {pc['hit_rate']:.2f}, "
          f"{pc['cached_tokens_served']}/{pc['prompt_tokens']} prompt "
          f"tokens served from cache "
          f"({pc['cached_token_fraction']:.0%}), "
          f"{pc['evictions']} blocks evicted")
    return {"turns": turns, "prefix_cache": pc}


def main(argv=None) -> dict:
    """Serves; returns the mode's numbers (outputs and tok/s, or each
    turn and the prefix cache's summary) and whether the engine is
    paged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chat", action="store_true",
                    help="multi-turn shared-prefix chat demo")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--system-len", type=int, default=96)
    ap.add_argument("--prefix-blocks", type=int, default=128)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import resolve_device

    cfg = get_smoke_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("serving demo targets decoder LMs; pick another arch")
    device = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=device)
    paged = T.positional_cache(cfg)
    engine = ServingEngine(
        cfg, params, max_seq_len=1024 if args.chat else 128,
        max_slots=args.slots, paged=paged, device=device,
        prefix_cache_blocks=(0 if args.no_prefix_cache or not paged
                             else args.prefix_blocks))
    print(f"arch={args.arch} (smoke variant, family={cfg.family}, "
          f"{'paged' if paged else 'dense'} KV, device={device})")
    out = run_chat(engine, cfg, args) if args.chat else run_burst(
        engine, cfg, args)
    return dict(out, paged=paged)


if __name__ == "__main__":
    main()
