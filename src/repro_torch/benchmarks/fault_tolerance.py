"""Fault-tolerance benchmark: kill 1 of 3 replicas mid-burst (the port of
``benchmarks/fault_tolerance.py``, at its sizes and with its keys).

A 3-replica gateway over the port's engines (one set of weights shared by
the three, random from ``init_params`` at seed 0) serves a greedy burst;
``replica1`` crashes at its step 4 (an injected ``FaultPlan`` crash), its
queued and in-flight requests are salvaged and re-routed to the survivors
under the retry policy, and every request must still complete with greedy
outputs bit-identical to a fault-free run of the same workload on one
replica (``greedy_tie_eps`` 1e-2, as the reference).

Written to ``BENCH_torch_faults.json`` with the reference's keys
(``requests_completed``, ``failed_requests``, ``salvage_success_rate``,
``bit_identical_outputs``, ``recovery_wall_s``, ...) and the device the
run took; the merged trace goes to ``--trace-out`` for
``scripts/trace_report.py --faults``.

  PYTHONPATH=src python -m repro_torch.benchmarks.fault_tolerance
  PYTHONPATH=src python -m repro_torch.benchmarks.fault_tolerance \\
      --device cpu

The default device is the card; without one it raises and writes
nothing.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Tuple

KILLED = "replica1"
CRASH_STEP = 4
TIE_EPS = 1e-2
TRACE_OUT = os.path.join("results", "trace_torch_faults.jsonl")


def _workload(cfg, n):
    import numpy as np

    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(17)
    return [Request(rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(4, 16)), dtype=np.int32),
                    SamplingParams(max_new_tokens=int(rng.integers(4, 9)),
                                   greedy=True))
            for _ in range(n)]


def run(quick: bool = True, out_path: str = "BENCH_torch_faults.json",
        device: str = "cuda", trace_out: str = TRACE_OUT
        ) -> List[Tuple[str, float, str]]:
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (FaultPlan, FaultSpec, ReplicaGateway,
                                     RequestFailed, Scheduler, ServingEngine,
                                     atomic_write_json)
    from repro_torch.serving.engine import resolve_device
    from repro_torch.serving.health import DEAD

    dev = resolve_device(device)
    arch = "qwen2-0.5b"
    block, max_seq_len, slots, prefill_batch, chunk = 16, 64, 4, 2, 8
    n_requests = 12 if quick else 18

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    num_blocks = slots * (max_seq_len // block)

    def engine():
        return ServingEngine(cfg, params, max_seq_len=max_seq_len,
                             max_slots=slots, kv_block_size=block,
                             prefill_chunk=chunk,
                             prefill_batch=prefill_batch,
                             paged=True, num_blocks=num_blocks,
                             greedy_tie_eps=TIE_EPS, device=dev)

    reqs = _workload(cfg, n_requests)

    # fault-free oracle: the same workload on one unharmed replica
    oracle_sched = Scheduler(engine())
    oracle_rids = [oracle_sched.submit(r) for r in reqs]
    oracle_sched.run()
    oracle = [oracle_sched.output(r) for r in oracle_rids]

    # the fleet under fault: replica1 crashes at its 5th step, squarely
    # mid-burst — in-flight decodes and queued admissions both salvage
    plan = FaultPlan([FaultSpec(kind="crash", replica=KILLED,
                                at_step=CRASH_STEP)])
    gw = ReplicaGateway.from_engines([engine() for _ in range(3)],
                                     tracing=True, fault_plan=plan)

    t0 = time.perf_counter()
    handles = [gw.submit(r) for r in reqs[: 2 * n_requests // 3]]
    for _ in range(CRASH_STEP + 2):        # let the crash land mid-burst
        gw.step()
    handles += [gw.submit(r) for r in reqs[2 * n_requests // 3:]]
    gw.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    assert gw.health[1].state == DEAD, "the injected crash never fired"
    stats = gw.stats()
    fleet = stats["fleet"]
    assert fleet["failovers"] == 1

    completed = failed = 0
    bit_identical = True
    for h, ref in zip(handles, oracle):
        out = gw.result(h)
        if isinstance(out, RequestFailed):
            failed += 1
            continue
        completed += 1
        if not np.array_equal(out, ref):
            bit_identical = False
    assert completed == n_requests, (
        f"{n_requests - completed} request(s) lost to the kill")
    assert failed == 0
    assert bit_identical, "failover changed greedy outputs"

    salvaged = [r for r in gw._requests.values() if r.attempts > 0]
    assert salvaged, "the kill salvaged nothing — crash landed too late"
    salvage_ok = sum(1 for r in salvaged if r.output is not None)
    salvage_rate = salvage_ok / len(salvaged)
    assert salvage_rate == 1.0, (
        f"only {salvage_ok}/{len(salvaged)} salvaged requests completed")

    # recovery wall: the failover event to the last salvaged retire
    events = gw.trace_events()
    fo_ts = next(e["ts"] for e in events if e["kind"] == "replica_failover")
    retried_rids = {(e["replica"], e["rid"]) for e in events
                    if e["kind"] == "replica_retry"}
    recovery_wall = max(
        (e["ts"] for e in events if e["kind"] == "retire"
         and (e["replica"], e["rid"]) in retried_rids),
        default=fo_ts) - fo_ts

    tot = stats["totals"]
    assert tot["requests_submitted"] == n_requests, (
        "retries double-counted as logical submits")
    assert tot["requests_completed"] == n_requests
    assert tot["requests_retried"] == len(salvaged)

    os.makedirs(os.path.dirname(trace_out) or ".", exist_ok=True)
    gw.export_trace_jsonl(trace_out)

    record = {
        "arch": arch, "quick": quick, "n_requests": n_requests,
        "replicas": 3, "killed_replica": KILLED,
        "crash_at_step": CRASH_STEP,
        "greedy_tie_eps": TIE_EPS,
        "block_size": block, "max_seq_len": max_seq_len,
        "max_slots": slots, "num_blocks": num_blocks,
        "requests_completed": completed,
        "failed_requests": failed,
        "salvaged_requests": len(salvaged),
        "salvage_success_rate": salvage_rate,
        "retries": tot["requests_retried"],
        "failovers": fleet["failovers"],
        "bit_identical_outputs": bit_identical,
        "wall_s": wall,
        "recovery_wall_s": recovery_wall,
        "health": fleet["health"],
        "trace_out": trace_out,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    atomic_write_json(out_path, record)

    return [
        ("fault_tolerance/kill_1_of_3", wall * 1e6,
         f"{n_requests} requests, {KILLED} crashed at step {CRASH_STEP}: "
         f"{completed} completed, {failed} failed, "
         f"{len(salvaged)} salvaged @ {salvage_rate:.0%}, "
         f"bit-identical to fault-free oracle, on {record['device']}, "
         f"results -> {out_path}"),
        ("fault_tolerance/recovery", recovery_wall * 1e6,
         f"failover -> last salvaged completion: {recovery_wall:.3f}s "
         f"({tot['requests_retried']} retried), trace -> {trace_out}"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="BENCH_torch_faults.json")
    ap.add_argument("--trace-out", default=TRACE_OUT)
    args = ap.parse_args(argv)
    rows = run(quick=not args.full, out_path=args.out, device=args.device,
               trace_out=args.trace_out)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
