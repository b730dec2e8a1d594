"""Serving launcher for the PyTorch port (one replica).

Counterpart of ``repro.launch.serve``: routes requests through the
continuous-batching scheduler (admission queue -> budgeted paged prefill ->
batched decode with per-request sampling -> early exit on each request's
own ``max_new_tokens`` / EOS) and prints per-request outputs plus TTFT /
throughput telemetry.  Weights are random, from the port's
``init_params`` at seed 0.  Prompts are built as the reference's launcher
builds them: ``--shared-prefix K`` shared tokens, then 4-11 random ones.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --paged --requests 8 --max-new 16 --shared-prefix 64

The port drives one ``Scheduler`` directly; ``--replicas > 1`` and
``--fabric`` need the gateway, which is ported with the fleet slice.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--max-slots", type=int, default=4,
                    help="continuous-batching slots")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--fabric", choices=("local", "mock"), default=None)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--greedy-tie-eps", type=float, default=1e-2,
                    help="deterministic greedy tie break: the lowest token "
                         "id within eps of the max logit (0 = raw argmax)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--paged", action="store_true",
                    help="paged attention: block-resident KV gathered "
                         "through block tables (the CUDA paged kernels)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (below worst case = "
                         "memory oversubscription)")
    ap.add_argument("--prefill-batch", type=int, default=4,
                    help="max co-admitted prompts per prefill round")
    ap.add_argument("--prefill-token-budget", type=int, default=None,
                    help="max executed prefill token positions per "
                         "scheduler step (SplitFuse-style interleaving)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=64,
                    help="prefix-store KV blocks (0 disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="open every prompt with this many shared tokens")
    ap.add_argument("--metrics-json", default=None,
                    help="export the scheduler telemetry JSON")
    ap.add_argument("--trace-out", default=None,
                    help="enable request-lifecycle tracing; writes "
                         "PATH.jsonl + PATH.chrome.json at end of run")
    ap.add_argument("--profile", action="store_true",
                    help="device-synchronised step-phase timing + shape "
                         "telemetry")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    return ap


def make_prompts(cfg, n: int, shared_prefix: int, seed: int = 0):
    """The reference launcher's prompts: ``shared_prefix`` shared random
    tokens, then 4-11 random tokens per request (numpy ``default_rng``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, shared_prefix, dtype=np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(4, 12)),
                                         dtype=np.int32)])
            for _ in range(n)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.replicas > 1 or args.fabric:
        raise SystemExit("--replicas > 1 and --fabric need the replica "
                         "gateway, which is ported with the fleet slice")
    if not args.paged:
        raise SystemExit("dense-mode serving is ported with the dense-mode "
                         "slice; pass --paged")

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine, Tracer)
    from repro_torch.serving.engine import resolve_device
    from repro_torch.serving.tracing import export_chrome_trace

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=device)
    engine = ServingEngine(cfg, params, max_seq_len=args.max_seq_len,
                           max_slots=args.max_slots,
                           prefix_cache_blocks=args.prefix_cache_blocks,
                           paged=True, num_blocks=args.num_blocks,
                           prefill_batch=args.prefill_batch,
                           greedy_tie_eps=args.greedy_tie_eps,
                           device=device)
    tracer = None
    if args.trace_out is not None:
        tracer = Tracer(enabled=True)
    sched = Scheduler(engine, prefill_token_budget=args.prefill_token_budget,
                      tracer=tracer, profile=args.profile)
    setup_s = time.perf_counter() - t0
    print(f"run config: arch={cfg.name} device={device} "
          f"max_slots={args.max_slots} max_seq_len={args.max_seq_len} "
          f"paged=True num_blocks={engine.kv.pool.num_blocks} "
          f"prefill_batch={engine.prefill_batch} "
          f"prefill_chunk={engine.prefill_chunk} "
          f"prefill_token_budget={args.prefill_token_budget} "
          f"prefix_cache_blocks={args.prefix_cache_blocks} "
          f"setup {setup_s:.1f} s")

    prompts = make_prompts(cfg, args.requests, args.shared_prefix)
    rids = [sched.submit(Request(
        p, SamplingParams(max_new_tokens=args.max_new, greedy=args.greedy,
                          temperature=args.temperature)))
        for p in prompts]
    sched.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    for i, rid in enumerate(rids):
        print(f"req {i}: {sched.output(rid).tolist()}")
    summ = sched.metrics.summary()
    print(f"{summ['total_new_tokens']} tokens over "
          f"{summ['requests_completed']} requests: "
          f"{summ['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {summ['ttft_ms']['p50']:.1f} ms, "
          f"ttft p95 {summ['ttft_ms']['p95']:.1f} ms, "
          f"latency p95 {summ['latency_ms']['p95']:.1f} ms, "
          f"slot occupancy {summ['slot_occupancy']:.2f}")
    dg = summ.get("decode_gap_ms", {})
    if dg.get("count"):
        print(f"decode step gap p50 {dg['p50']:.2f} ms, "
              f"p95 {dg['p95']:.2f} ms over {dg['count']} gaps")
    pc = summ.get("prefix_cache", {})
    if pc.get("hits", 0) or pc.get("misses", 0):
        print(f"prefix cache: hit rate {pc['hit_rate']:.2f}, "
              f"{pc['cached_tokens_served']}/{pc['prompt_tokens']} prompt "
              f"tokens served from cache, {pc['evictions']} evictions")
    if args.profile:
        ps = sched.profiler.summary()
        print(f"profile: {ps['steps']} steps  " + "  ".join(
            f"{p} p95 {ps[f'{p}_ms']['p95']:.2f}ms"
            for p in ("admit", "prefill", "decode", "sample")))
    stats = {"summary": summ, "occupancy": engine.kv.occupancy(),
             "device": str(device), "setup_s": setup_s,
             "prefill_tokens": engine.prefill_tokens,
             "prefill_tokens_executed": engine.prefill_tokens_executed,
             "decode_steps": engine.decode_steps}
    if device.type == "cuda":
        stats["device_name"] = torch.cuda.get_device_name(device)
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(stats, f, indent=2, sort_keys=True, default=str)
        print(f"metrics -> {args.metrics_json}")
    if tracer is not None:
        jsonl = tracer.export_jsonl(f"{args.trace_out}.jsonl")
        chrome = export_chrome_trace({"replica0": tracer.snapshot()},
                                     f"{args.trace_out}.chrome.json")
        print(f"trace: {tracer.emitted_events} events -> {jsonl} + {chrome}")
    return sched


if __name__ == "__main__":
    main()
