"""Serving launcher for the PyTorch port.

Counterpart of ``repro.launch.serve``: routes requests through the
continuous-batching scheduler (admission queue -> budgeted prefill ->
batched decode with per-request sampling -> early exit on each request's
own ``max_new_tokens`` / EOS) behind the prefix-affine, load-balanced,
health-checked replica gateway (``serving/gateway.py``), always — one
replica or ``--replicas N``, each conceptually one ``ch-run`` capsule.  It
prints per-request outputs, the gateway-merged TTFT / throughput
telemetry and each replica's round programs (on the card every round
replays a CUDA graph captured at its first round).  ``--paged`` serves
from paged KV blocks (the CUDA paged kernels); without it, as in the
reference, each slot owns a dense KV stripe (attended by the plain
PyTorch attention, or by the int8 flash kernel for a config with
``kv_cache_dtype="int8"``).  Weights are random, from the port's
``init_params`` at seed 0, drawn once on the device by a generator
there and shared by every in-process replica.
Prompts are built as the reference's launcher builds them:
``--shared-prefix K`` shared tokens, then 4-11 random ones.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --paged --replicas 3 --requests 24 --max-new 32 --shared-prefix 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --device cpu --requests 4 --max-new 8   # dense mode
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --fabric local --replicas 2             # worker processes
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --paged --max-slots 8 --max-seq-len 1024 \\
      --requests 8 --max-new 32 --shared-prefix 256 --greedy   # MoE, 61 GB

The moe family (qwen3-moe-30b-a3b, dbrx-132b) serves paged and dense as
the dense decoders do; dbrx at full width (263 GB in bf16) fits no single
card.  The ssm (mamba2-1.3b) and hybrid (zamba2-1.2b) families serve in
dense mode only: their cache holds recurrent state, so ``--paged`` raises the KV
cache's ``ValueError`` and the engine keeps no prefix store, as in the
reference.  qwen2-vl-72b (vlm) serves text, paged or dense, as the
reference's engine does: no patches, plain RoPE at each token's position
(its 80 layers, 145 GB in bf16, fit no single card; the engine serves
it cut in depth).  whisper-small (encdec)
is refused, with the reference's words; it serves through ``Scheduler``
and ``ServingEngine``, each request carrying its frames.

As in the reference: ``--tenant`` labels requests round-robin (per-tenant
percentiles), ``--slo-config`` arms every replica's SLO monitor,
``--metrics-json`` writes the gateway's stats (per replica, merged
totals, fleet health), ``--metrics-out`` the merged totals (re-written
every ``--metrics-interval-steps`` gateway steps), ``--trace-out BASE``
the merged trace (``BASE.jsonl`` + ``BASE.chrome.json``; read it with the
reference's ``scripts/trace_report.py``), ``--trace-buffer-events`` sizes
each replica's ring, and ``--profile`` prints each replica's step phases
on the device's clock (each phase's device time and the step's device
idle, from the span recorder's CUDA events; nothing synchronises) and
recompiles and, paged, the two paged kernels' profiles on operands in
the engine's KV dtype beside their bounds (``serving/profiling.py``).

``--fabric {local,mock}`` runs the replicas as fabric workers behind the
shared-filesystem mailbox (``serving/fabric/``): ``local`` real worker
processes (which share the one card, each with its own CUDA context),
``mock`` deterministic in-process workers.  It requires ``--smoke`` (the
workers rebuild bit-identical weights from the declarative smoke spec)
and refuses ``--profile`` and ``--slo-config``, as the reference does;
``--spool DIR`` picks the spool directory.

``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain PyTorch versions (and reaches fabric
workers through the model spec's engine kwargs).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--max-slots", type=int, default=4,
                    help="continuous-batching slots per replica")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--fabric", choices=("local", "mock"), default=None,
                    help="launch replicas as fabric workers behind the "
                         "shared-filesystem mailbox: 'local' = worker "
                         "processes (LocalProcessBackend), 'mock' = "
                         "deterministic in-process workers (MockBackend); "
                         "requires --smoke")
    ap.add_argument("--spool", default=None, metavar="DIR",
                    help="fabric spool directory "
                         "(default: results/fabric-spool)")
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
                    help="per-replica prefix-store KV blocks (0 disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="open every prompt with this many shared tokens")
    ap.add_argument("--tenant", action="append", default=None,
                    metavar="NAME",
                    help="tenant label(s); repeat or comma-separate — "
                         "requests are assigned round-robin")
    ap.add_argument("--slo-config", default=None, metavar="PATH",
                    help="JSON SLO policy file ({\"default\": {...}, "
                         "\"tenants\": {name: {...}}})")
    ap.add_argument("--metrics-json", default=None,
                    help="export per-replica + merged telemetry JSON")
    ap.add_argument("--metrics-out", default=None,
                    help="export the gateway-merged totals JSON")
    ap.add_argument("--metrics-interval-steps", type=int, default=None,
                    metavar="N",
                    help="with --metrics-out: atomically re-write the "
                         "totals every N gateway steps")
    ap.add_argument("--trace-out", default=None,
                    help="enable request-lifecycle tracing; writes "
                         "PATH.jsonl + PATH.chrome.json at end of run")
    ap.add_argument("--trace-buffer-events", type=int, default=None,
                    help="per-replica trace ring-buffer depth")
    ap.add_argument("--profile", action="store_true",
                    help="step phases on the device's clock, recompile "
                         "telemetry and the paged kernels' profiles")
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


def _programs(engine) -> dict:
    return {name: {"captures": prog.captures, "replays": prog.replays,
                   "capture_s": prog.capture_s}
            for name, prog in sorted(engine.programs.items())}


def main(argv=None):
    """Run the launcher; returns the :class:`ReplicaGateway` it served
    through (its replicas' schedulers and engines stay inspectable)."""
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ReplicaGateway, Request, SamplingParams,
                                     ServingEngine, SLOConfig,
                                     atomic_write_json)
    from repro_torch.serving.engine import resolve_device

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        # as the reference: its prompts carry no frames (whisper serves
        # through Scheduler + ServingEngine with each request's frames)
        raise SystemExit("serve launcher targets decoder LMs")
    tenants = [t for arg in (args.tenant or ["default"])
               for t in arg.split(",") if t]
    slo_config = (SLOConfig.from_json(args.slo_config)
                  if args.slo_config else None)
    fabric_backend = None
    spool = None
    t0 = time.perf_counter()
    if args.fabric:
        if not args.smoke:
            raise SystemExit("--fabric requires --smoke: workers rebuild "
                             "bit-identical weights from the declarative "
                             "smoke-config spec")
        if args.profile or args.slo_config:
            raise SystemExit("--fabric replicas live in other processes; "
                             "--profile / --slo-config introspection is "
                             "in-process only")
        from repro_torch.serving import (LocalProcessBackend, MockBackend,
                                         launch_fabric_replicas)
        device = resolve_device(args.device)
        backend_cls = {"local": LocalProcessBackend, "mock": MockBackend}
        fabric_backend = backend_cls[args.fabric]()
        spool = Path(args.spool or "results/fabric-spool")
        engine_kw = {"max_seq_len": args.max_seq_len,
                     "max_slots": args.max_slots,
                     "prefill_batch": args.prefill_batch,
                     "greedy_tie_eps": args.greedy_tie_eps}
        if device.type != "cuda":
            engine_kw["device"] = str(device)
        model_spec = {"config": args.arch, "seed": 0, "engine": engine_kw}
        gateway = launch_fabric_replicas(
            args.replicas, fabric_backend, spool, model_spec=model_spec,
            tracing=True)
        print(f"run config: arch={cfg.name} device={device} "
              f"replicas={args.replicas} fabric={args.fabric} spool={spool} "
              f"max_slots={args.max_slots} max_seq_len={args.max_seq_len} "
              f"prefill_batch={args.prefill_batch}")
        for rep in gateway.replicas:
            print(f"fabric replica {rep.name}: {rep.capsule['backend']} "
                  f"job {rep.capsule['job_id']} "
                  f"(partition {rep.capsule['partition']})")
    else:
        device = resolve_device(args.device)
        # one set of weights, drawn on the device one layer slice at a
        # time and shared by every replica (a full-width qwen3-moe takes
        # ~40 minutes to draw on the CPU)
        params = T.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device=device)
        engines = [ServingEngine(cfg, params, max_seq_len=args.max_seq_len,
                                 max_slots=args.max_slots, rng_seed=r,
                                 prefix_cache_blocks=args.prefix_cache_blocks,
                                 paged=args.paged,
                                 num_blocks=args.num_blocks,
                                 prefill_batch=args.prefill_batch,
                                 greedy_tie_eps=args.greedy_tie_eps,
                                 device=device)
                   for r in range(args.replicas)]
        gateway = ReplicaGateway.from_engines(
            engines, prefill_token_budget=args.prefill_token_budget,
            tracing=args.trace_out is not None,
            trace_buffer_events=args.trace_buffer_events,
            slo_config=slo_config, profile=args.profile)
        print(f"run config: arch={cfg.name} device={device} "
              f"replicas={args.replicas} "
              f"max_slots={args.max_slots} max_seq_len={args.max_seq_len} "
              f"paged={args.paged} num_blocks={engines[0].kv.pool.num_blocks} "
              f"prefill_batch={engines[0].prefill_batch} "
              f"prefill_chunk={engines[0].prefill_chunk} "
              f"prefill_token_budget={args.prefill_token_budget} "
              f"prefix_cache_blocks={args.prefix_cache_blocks} "
              f"setup {time.perf_counter() - t0:.1f} s")
    setup_s = time.perf_counter() - t0

    prompts = make_prompts(cfg, args.requests, args.shared_prefix)
    handles = [gateway.submit(Request(
        p, SamplingParams(max_new_tokens=args.max_new, greedy=args.greedy,
                          temperature=args.temperature),
        tenant=tenants[i % len(tenants)])) for i, p in enumerate(prompts)]
    # drain manually so periodic snapshots can flush mid-run: a killed
    # capsule then leaves the last atomic snapshot, not nothing
    gateway.draining = True
    for rep in gateway.replicas:
        rep.scheduler.draining = True
    steps = 0
    while gateway.has_work:
        gateway.step()
        steps += 1
        if (args.metrics_out and args.metrics_interval_steps
                and steps % args.metrics_interval_steps == 0):
            atomic_write_json(args.metrics_out, gateway.stats()["totals"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    for i, h in enumerate(handles):
        rep = gateway.replicas[h[0]]
        print(f"req {i} [{rep.name}]: {gateway.result(h).tolist()}")
    stats = gateway.stats()
    tot = stats["totals"]
    print(f"{tot['total_new_tokens']} tokens over "
          f"{tot['requests_completed']} requests on "
          f"{tot['replicas']} replica(s): "
          f"{tot['tokens_per_s']:.1f} tok/s, "
          f"ttft p95 {tot['ttft_ms_p95']:.1f} ms, "
          f"latency p95 {tot['latency_ms_p95']:.1f} ms, "
          f"slot occupancy {tot['slot_occupancy']:.2f}")
    dg = tot.get("decode_gap_ms", {})
    if dg.get("count"):
        print(f"decode jitter: inter-token gap p50 {dg['p50']:.2f} ms, "
              f"p95 {dg['p95']:.2f} ms, max {dg['max']:.2f} ms "
              f"over {dg['count']} gaps")
    pc = tot.get("prefix_cache", {})
    if pc.get("hits", 0) or pc.get("misses", 0):
        print(f"prefix cache: hit rate {pc['hit_rate']:.2f}, "
              f"{pc['cached_tokens_served']}/{pc['prompt_tokens']} prompt "
              f"tokens served from cache, {pc['evictions']} evictions")
    if len(tenants) > 1 or tenants != ["default"]:
        for name, ts in sorted(tot.get("tenants", {}).items()):
            print(f"tenant {name}: {ts['requests_completed']} requests, "
                  f"{ts['tokens_per_s']:.1f} tok/s, "
                  f"ttft p95 {ts['ttft_ms']['p95']:.1f} ms, "
                  f"gap p95 {ts['decode_gap_ms']['p95']:.2f} ms, "
                  f"queue wait p95 {ts['queue_wait_ms']['p95']:.2f} ms")
    if slo_config is not None:
        for rep in gateway.replicas:
            s = rep.scheduler.tracer.slo.summary()
            print(f"SLO [{rep.name}]: {s['breaches']} breach(es), "
                  f"active: {s['active'] or 'none'}")
    if fabric_backend is None:
        for rep in gateway.replicas:
            eng = rep.scheduler.engine
            progs = _programs(eng)
            stats["replicas"][rep.name]["programs"] = progs
            stats["replicas"][rep.name]["occupancy"] = eng.kv.occupancy()
            print(f"programs [{rep.name}]: " + ", ".join(
                f"{name} {p['captures']} capture(s) in "
                f"{p['capture_s']:.2f} s, {p['replays']} replays"
                for name, p in progs.items()))
    if args.profile:
        for rep in gateway.replicas:
            ps = rep.scheduler.profiler.summary()
            phases = "  ".join(
                f"{p} p95 {ps[f'{p}_ms']['p95']:.2f}ms"
                for p in ("admit", "prefill", "decode", "sample", "idle"))
            print(f"profile [{rep.name}]: {ps['steps']} steps, device "
                  f"time  {phases}")
            rs = rep.scheduler.engine.recompiles.summary()
            print(f"recompiles [{rep.name}]: {rs['compiles_total']} "
                  f"compilations, {rs['post_warm_recompiles']} post-warm, "
                  f"churning: {rs['churning'] or 'none'}")
        if args.paged:
            from repro_torch.serving.profiling import (HBM_BW, PEAK_FLOPS,
                                                       profile_paged_kernels,
                                                       profile_shapes)
            engine = gateway.replicas[0].scheduler.engine
            dtype = profile_shapes(engine)["dtype"]
            profs = profile_paged_kernels(engine)
            stats["kernel_profiles"] = profs
            for name, prof in profs.items():
                bound_ms = max(prof["bytes_accessed"] / HBM_BW,
                               prof["flops"] / PEAK_FLOPS[dtype]) * 1e3
                print(f"kernel {name} ({str(dtype)[6:]}): "
                      f"{prof['wall_ms_median']:.4f} ms "
                      f"(bound {bound_ms:.4f} ms), {prof['flops']:.3g} flops, "
                      f"{prof['achieved_tflops']:.3f} TFLOP/s "
                      f"({prof['fraction_of_peak_flops']:.1%} of peak), "
                      f"{prof['achieved_gbps']:.1f} GB/s "
                      f"({prof['fraction_of_peak_bw']:.1%} of HBM) "
                      f"on {prof['device']}")
    stats["device"] = str(device)
    stats["setup_s"] = setup_s
    if device.type == "cuda":
        stats["device_name"] = torch.cuda.get_device_name(device)
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(stats, f, indent=2, sort_keys=True, default=str)
        print(f"metrics -> {args.metrics_json}")
    if args.metrics_out:
        out = atomic_write_json(args.metrics_out, stats["totals"])
        print(f"merged metrics summary -> {out}")
    if args.trace_out:
        if fabric_backend is not None:
            from repro_torch.serving import (collect_fabric_traces,
                                             shutdown_fabric)
            # worker streams land in the spool only at clean exit — stop
            # the fleet first, then merge gateway + worker events (no
            # chrome export: worker clocks are per-process monotonic)
            shutdown_fabric(gateway)
            n_ev = collect_fabric_traces(gateway, spool,
                                         f"{args.trace_out}.jsonl")
            print(f"fabric trace: {n_ev} merged events -> "
                  f"{args.trace_out}.jsonl (inspect: python "
                  f"scripts/trace_report.py --fleet "
                  f"{args.trace_out}.jsonl)")
        else:
            jsonl = gateway.export_trace_jsonl(f"{args.trace_out}.jsonl")
            chrome = gateway.export_chrome_trace(
                f"{args.trace_out}.chrome.json")
            n_ev = sum(tr.emitted_events for tr in gateway.tracers)
            n_drop = sum(tr.dropped_events for tr in gateway.tracers)
            print(f"trace: {n_ev} events ({n_drop} dropped by ring) -> "
                  f"{jsonl} + {chrome} "
                  f"(inspect: python scripts/trace_report.py {jsonl})")
    if fabric_backend is not None:
        from repro_torch.serving import shutdown_fabric
        shutdown_fabric(gateway)    # idempotent if the trace path ran
    return gateway


if __name__ == "__main__":
    main()
