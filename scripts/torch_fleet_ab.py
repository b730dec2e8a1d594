#!/usr/bin/env python3
"""The serving launcher's fleet run at one replica and at three, with and
without ``--profile``, in turns on one card.

    python scripts/torch_fleet_ab.py [--pairs 2] [--out FILE]
    python scripts/torch_fleet_ab.py --smoke --device cpu --pairs 1

Every run is ``repro_torch.launch.serve.main`` with the flags of
``chip_smoke.py`` phase 17 (a) (qwen2-0.5b, paged, 8 slots a replica,
max_seq_len 1,024, 24 greedy requests of a 256-token shared prefix plus
4-11 own tokens, 32 new each, tenants a and b), only ``--replicas`` and
``--profile`` changed, so that a difference between two modes is theirs
alone.  One warm-up run (three replicas, profiled) builds the kernels;
then ``--pairs`` rounds of the four modes in turns, forward then reversed
(A B C D D C B A).  Each run reads from the returned gateway: the merged
tokens/s (each replica's new tokens over its own span, summed, as the
gateway's stats merge them), TTFT p50 / p95 over every request, the decode
gap p95, the wall time of the call (weights and captures included), the
requests routed to each replica, the prefix cache's hits and cached
tokens, the prefill tokens executed and the round programs' replays.
Prints the card's name and power limit, one line a run, then one JSON line
with every run and each mode's median.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MODES = [(1, False), (3, False), (1, True), (3, True)]


def run_once(replicas: int, profile: bool, extra) -> dict:
    import numpy as np
    import torch

    from repro_torch.launch import serve as launcher

    argv = ["--arch", "qwen2-0.5b", "--paged", "--replicas", str(replicas),
            "--max-slots", "8", "--max-seq-len", "1024", "--requests", "24",
            "--max-new", "32", "--shared-prefix", "256", "--greedy",
            "--tenant", "a,b", *extra] + (["--profile"] if profile else [])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        gw = launcher.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tot = gw.stats()["totals"]
    ttft = [t * 1e3 for rep in gw.replicas
            for t in rep.scheduler.metrics.ttft_s()]
    out = {"replicas": replicas, "profile": profile,
           "requests": tot["requests_completed"],
           "new_tokens": tot["total_new_tokens"],
           "tokens_per_s": tot["tokens_per_s"],
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           "decode_gap_ms_p95": tot["decode_gap_ms"]["p95"],
           "wall_s": wall, "routed": [r.routed for r in gw.replicas],
           "prefix_hits": tot["prefix_cache"]["hits"],
           "cached_tokens": tot["prefix_cache"]["cached_tokens_served"],
           "prefill_tokens_executed": tot["prefill_tokens"]["executed"],
           **{f"{name}_replays": sum(
               rep.scheduler.engine.programs[name].replays
               for rep in gw.replicas)
              for name in ("prefill_paged", "decode_step")}}
    del gw
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    extra = (["--smoke"] if args.smoke else []) + ["--device", args.device]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60) if args.device == "cuda" else None
    print(smi.stdout.strip() if smi else "cpu", flush=True)

    warm = run_once(3, True, extra)
    print(f"warm-up: {json.dumps(warm)}", flush=True)
    runs = []
    for _ in range(args.pairs):
        for replicas, profile in MODES + MODES[::-1]:
            r = run_once(replicas, profile, extra)
            runs.append(r)
            print(json.dumps(r), flush=True)
    medians = {}
    for replicas, profile in MODES:
        mine = [r for r in runs if r["replicas"] == replicas
                and r["profile"] == profile]
        medians[f"replicas {replicas}{' profile' if profile else ''}"] = {
            k: statistics.median(r[k] for r in mine)
            for k in ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p95",
                      "decode_gap_ms_p95", "wall_s", "prefix_hits",
                      "prefill_tokens_executed", "prefill_paged_replays",
                      "decode_step_replays")}
    line = json.dumps({"runs": runs, "medians": medians})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all(r["requests"] == 24 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
