#!/usr/bin/env python3
"""Serving a full-width model (qwen2-0.5b by default) on one tree of the
port: the launcher's workload repeated, the decode step alone, then dense
serving with the int8 KV cache.

    python scripts/torch_serve_profile.py [--src DIR] [--runs 3] [--steps 40]
        [--arch qwen2-0.5b] [--dense]

Runs ``repro_torch.launch.serve`` for ``--arch``, paged (or in dense mode
with ``--dense``, the only mode of the ssm and hybrid families: one stripe
per slot, prompts replayed at batch 1) (8 slots, max_seq_len 2048, 12
greedy requests of a 256-token shared prefix plus 4-11 own tokens, 32 new
each, prefill batch 4, token budget 512, 256 prefix blocks) once to build
the kernels and warm the allocator, then ``--runs`` more times, each with a
fresh engine, and reads tokens/s and the decode gap from each scheduler.
Then on the last engine: 8 of those prompts prefilled, and ``--steps``
decode steps (``decode_once`` + ``sample_tokens``, greedy) timed on the
host clock, both until ``decode_once`` returns (its host dispatch: the
kernels are queued, not waited for) and until the sampled tokens are on
the host (the step); the last 5 steps once more under ``torch.profiler``
for the aten ops the host dispatches per step, the device kernels per
step and the card's kernel time and busy share.  Then dense int8 serving
(``chip_smoke.py`` phase 6's workload: 8 slots x 1,024 positions, prefill
chunk 16, 64 prefix blocks, 12 greedy requests of 32 shared + 16-96 own
tokens, 32 new each) on a fresh engine: tokens/s, TTFT and the decode
gap.  Where the tree's engine has round programs (CUDA graphs), each
program's captures, replays and capture seconds are reported too.  Prints
the card's name and power limit, then one JSON line.  ``--src`` names the ``src`` directory whose
``repro_torch`` runs (default: this checkout's), so that two trees compare
on one card: unpack the other with ``git archive`` into a git-ignored
directory and run them alternately in one call (a, b, b, a, ...).
``--smoke --device cpu`` runs the smoke config on the CPU, as a check of
the script itself.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARGS = ["--max-slots", "8", "--max-seq-len", "2048",
              "--prefill-batch", "4", "--prefill-token-budget", "512",
              "--prefix-cache-blocks", "256", "--shared-prefix", "256",
              "--requests", "12", "--max-new", "32", "--greedy"]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def decode_steps(torch, engine, prompts, steps: int, dev) -> dict:
    """Prefill ``prompts`` into free slots, then ``steps`` greedy decode
    steps over every slot: host dispatch and step time per step (ms), and
    the kernel time of 5 more steps under ``torch.profiler``."""
    import numpy as np
    B = engine.max_slots
    tokens = np.zeros(B, np.int32)
    positions = np.zeros(B, np.int32)
    slots = []
    for p, (slot, logits) in zip(prompts[:B],
                                 engine.prefill_into_slots(prompts[:B])):
        tokens[slot] = int(np.argmax(logits))
        positions[slot] = len(p)
        slots.append(slot)
    temps, greedy = np.zeros(B, np.float32), np.ones(B, bool)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def step():
        t0 = time.perf_counter()
        logits = engine.decode_once(tokens, positions)
        t1 = time.perf_counter()
        tokens[:] = engine.sample_tokens(logits, temps, greedy)
        t2 = time.perf_counter()
        positions[:] += 1
        return (t1 - t0) * 1e3, (t2 - t0) * 1e3

    for _ in range(3):
        step()
    sync()
    disp, wall = zip(*(step() for _ in range(steps)))
    out = {"steps": steps,
           "dispatch_ms": {"p50": pct(disp, 0.5), "p95": pct(disp, 0.95),
                           "mean": sum(disp) / steps},
           "step_ms": {"p50": pct(wall, 0.5), "p95": pct(wall, 0.95),
                       "mean": sum(wall) / steps}}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CPU")
           and e.key.startswith("aten::")]
    # the host's work per step: every aten op dispatched (nested ones too)
    out["aten_ops_per_step"] = sum(e.count for e in ops) / 5
    if dev.type == "cuda":
        import chip_smoke
        br = chip_smoke.profile_breakdown(prof, wall_ms)
        out["profiled_5_steps"] = {k: br[k] for k in (
            "wall_ms", "kernel_ms", "busy_share", "top")}
        # the card's busy share of an unprofiled step: kernel time a step
        # (profiled) over the mean step time of the 40 unprofiled steps
        out["busy_share"] = br["kernel_ms"] / 5 / out["step_ms"]["mean"]
        out["kernels_per_step"] = sum(
            e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")) / 5
    for slot in slots:
        engine.free_slot(slot)
    return out


def programs(engine) -> dict:
    """Each round program's captures, replays and capture seconds (none
    on a tree whose engine runs eagerly)."""
    return {name: {"captures": p.captures, "replays": p.replays,
                   "capture_s": p.capture_s}
            for name, p in sorted(getattr(engine, "programs", {}).items())}


def dense_int8(torch, cfg, params, dev) -> dict:
    """``chip_smoke.py`` phase 6's dense int8 workload on a fresh engine:
    tokens/s, TTFT and decode gap from the scheduler, and the wall time."""
    import numpy as np
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    rs = np.random.default_rng(3)
    shared = rs.integers(0, cfg.vocab_size, 32, dtype=np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(16, 97)), dtype=np.int32)])
        for _ in range(12)]
    eng = ServingEngine(cfg.with_(kv_cache_dtype="int8"), params,
                        paged=False, max_slots=8, max_seq_len=1024,
                        prefill_chunk=16, prefix_cache_blocks=64, device=dev)
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(Request(p, SamplingParams(max_new_tokens=32,
                                               greedy=True)))
    t0 = time.perf_counter()
    sched.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    summ = sched.metrics.summary()
    dg = summ.get("decode_gap_ms", {})
    return {"tokens_per_s": summ["tokens_per_s"],
            "new_tokens": summ["total_new_tokens"], "wall_s": wall,
            "ttft_p50_ms": summ["ttft_ms"]["p50"],
            "decode_gap_p50_ms": dg.get("p50"),
            "decode_gap_p95_ms": dg.get("p95"),
            "decode_steps": eng.decode_steps,
            "prefill_tokens_executed": eng.prefill_tokens_executed,
            "programs": programs(eng)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--dense", action="store_true",
                    help="serve the launcher's workload in dense mode")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch import serve
    dev = torch.device(args.device)
    argv = (["--arch", args.arch] + ([] if args.dense else ["--paged"])
            + SERVE_ARGS + ["--device", args.device]
            + (["--smoke"] if args.smoke else []))
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no output")
    runs = []
    for i in range(args.runs + 1):
        with contextlib.redirect_stdout(io.StringIO()):
            sched = serve.main(argv).replicas[0].scheduler
        summ = sched.metrics.summary()
        dg = summ.get("decode_gap_ms", {})
        run = {"tokens_per_s": summ["tokens_per_s"],
               "ttft_p50_ms": summ["ttft_ms"]["p50"],
               "decode_gap_p50_ms": dg.get("p50"),
               "decode_gap_p95_ms": dg.get("p95")}
        print(("warm-up " if i == 0 else f"run {i} ") + json.dumps(run),
              flush=True)
        if i:
            runs.append(run)
    engine = sched.engine
    prompts = serve.make_prompts(engine.cfg, 8, 256)
    dec = decode_steps(torch, engine, prompts, args.steps, dev)
    dec["programs"] = programs(engine)
    dense = dense_int8(torch, engine.cfg, engine.params, dev)
    print(json.dumps({"src": str(src), "arch": args.arch,
                      "dense": args.dense, "runs": runs, "decode": dec,
                      "dense_int8": dense}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
