"""Fabric benchmark: 3 worker *processes*, SIGKILL one mid-burst (the port
of ``benchmarks/fabric.py``, at its sizes and with its keys).

Three replica workers launched as separate processes by
:class:`~repro_torch.serving.fabric.backends.LocalProcessBackend`
(``python -m repro_torch.serving.fabric.worker``), talking to the gateway
only through the shared-filesystem mailbox, serve a greedy burst; one
worker is SIGKILLed while its heartbeat shows in-flight requests.  The
gateway sees the death as a cluster would (the process vanishes,
heartbeats stop), salvages the victim's queued and in-flight work from its
last heartbeat's emitted-token map, re-routes it to the survivors, and
every request must still complete bit-identical to the oracle: the same
workload on one in-process scheduler over an engine built from the same
model spec, on the same device, in this process.

On the card the three workers share its one card, each process with its
own CUDA context; each builds its engine from the spec (the port's
``init_params`` at the spec's seed) and captures its round programs before
its first heartbeat.  ``--device cpu`` reaches the workers through the
model spec's engine kwargs (``{"engine": {..., "device": "cpu"}}``).

Written to ``BENCH_torch_fabric.json`` with the reference's keys
(``requests_completed``, ``failed_requests``, ``salvage_success_rate``,
``bit_identical_outputs``, ``recovery_wall_s``, ...) and the device; the
merged gateway + worker trace goes to ``--trace-out`` for
``scripts/trace_report.py --fleet``.

  PYTHONPATH=src python -m repro_torch.benchmarks.fabric
  PYTHONPATH=src python -m repro_torch.benchmarks.fabric --device cpu

The default device is the card; without one it raises and writes
nothing.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

KILLED_IDX = 1
MAX_NEW = 16
TRACE_OUT = os.path.join("results", "trace_torch_fabric.jsonl")


def _workload(vocab_size, n):
    import numpy as np

    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(11)
    return [Request(rng.integers(0, vocab_size,
                                 int(rng.integers(3, 10)), dtype=np.int32),
                    SamplingParams(max_new_tokens=MAX_NEW, greedy=True))
            for _ in range(n)]


def wait_for_workers(gw, timeout_s: float = 180.0) -> float:
    """Block until every worker of ``gw`` has written its first heartbeat
    (interpreter start, engine build and, on the card, the round
    programs' capture all come before it), so the burst meets a fleet
    that is up; returns the seconds waited.  Raises ``TimeoutError`` past
    ``timeout_s`` and ``RuntimeError`` for a worker job that failed."""
    t0 = time.monotonic()
    for rep in gw.replicas:
        rs = rep.scheduler
        while rs.mailbox.read_heartbeat() is None:
            if rs.backend.poll(rs.handle) == "FAILED":
                raise RuntimeError(f"{rep.name}: worker failed before its "
                                   f"first heartbeat ({rs.handle.error})")
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"{rep.name}: no heartbeat within "
                                   f"{timeout_s} s")
            time.sleep(0.01)
    return time.monotonic() - t0


def model_spec_for(device) -> dict:
    """The workers' model spec: the reference's default on the card (the
    engine's own device), the default engine kwargs plus ``"device"``
    anywhere else."""
    from repro_torch.serving.fabric.worker import DEFAULT_MODEL_SPEC
    if str(device).startswith("cuda"):
        return None
    return {"engine": dict(DEFAULT_MODEL_SPEC["engine"],
                           device=str(device))}


def run(quick: bool = True, out_path: str = "BENCH_torch_fabric.json",
        device: str = "cuda", trace_out: str = TRACE_OUT
        ) -> List[Tuple[str, float, str]]:
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import (HealthConfig, LocalProcessBackend,
                                     RequestFailed, Scheduler,
                                     atomic_write_json,
                                     collect_fabric_traces,
                                     launch_fabric_replicas, shutdown_fabric)
    from repro_torch.serving.engine import resolve_device
    from repro_torch.serving.fabric import build_engine
    from repro_torch.serving.health import DEAD

    dev = resolve_device(device)
    spec = model_spec_for(dev)
    n_requests = 12 if quick else 18
    cfg = get_smoke_config("qwen2-0.5b")
    reqs = _workload(cfg.vocab_size, n_requests)

    # fault-free oracle: the same workload on one in-process scheduler
    # built from the same declarative model spec the workers rebuild —
    # bit-identity across the process boundary is the claim under test
    oracle_sched = Scheduler(build_engine(spec))
    oracle_rids = [oracle_sched.submit(r) for r in reqs]
    oracle_sched.run()
    oracle = [oracle_sched.output(r) for r in oracle_rids]

    spool = Path(tempfile.mkdtemp(prefix="fabric-bench-")) / "spool"
    backend = LocalProcessBackend()
    gw = launch_fabric_replicas(
        3, backend, spool, model_spec=spec, tracing=True,
        health=HealthConfig(degraded_after=20, quarantine_after=40,
                            auto_rejoin=False))
    try:
        # the burst starts once the fleet is up: a worker that boots late
        # would otherwise meet a finished burst on its peers
        boot_s = wait_for_workers(gw)
        t0 = time.perf_counter()
        handles = [gw.submit(r) for r in reqs]
        victim = gw.replicas[KILLED_IDX].scheduler
        killed_name = gw.replicas[KILLED_IDX].name

        # step until the victim's heartbeat shows in-flight work, then
        # SIGKILL it — the kill must land squarely mid-burst, with both
        # admitted decodes and queued submits on the dying process
        killed = False
        for _ in range(200):
            gw.step()
            if victim.active or victim.prefilling:
                backend.kill(victim.handle)
                killed = True
                break
        assert killed, ("the victim never reported in-flight work — "
                        "the burst finished before the kill could land")
        gw.drain()
        wall = time.perf_counter() - t0

        assert gw.health[KILLED_IDX].state == DEAD, (
            "the SIGKILLed worker was never declared dead")
        stats = gw.stats()
        fleet = stats["fleet"]
        assert fleet["failovers"] >= 1

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
        assert bit_identical, ("cross-process failover changed greedy "
                               "outputs")

        salvaged = [r for r in gw._requests.values() if r.attempts > 0]
        assert salvaged, ("the kill salvaged nothing — it landed after "
                          "the victim went idle")
        salvage_ok = sum(1 for r in salvaged if r.output is not None)
        salvage_rate = salvage_ok / len(salvaged)
        assert salvage_rate == 1.0, (
            f"only {salvage_ok}/{len(salvaged)} salvaged requests "
            f"completed")

        # recovery wall: the failover event to the last salvaged retire
        events = gw.trace_events()
        fo_ts = next(e["ts"] for e in events
                     if e["kind"] == "replica_failover")
        retried = {(e["replica"], e["rid"]) for e in events
                   if e["kind"] == "replica_retry"}
        recovery_wall = max(
            (e["ts"] for e in events if e["kind"] == "retire"
             and (e["replica"], e["rid"]) in retried),
            default=fo_ts) - fo_ts

        # stop the survivors before collecting: workers export their
        # trace streams (engine steps included) at clean exit, and the
        # merged fleet timeline should carry them — the SIGKILLed
        # worker is the one stream legitimately missing
        shutdown_fabric(gw)
        os.makedirs(os.path.dirname(trace_out) or ".", exist_ok=True)
        n_events = collect_fabric_traces(gw, spool, trace_out)

        record = {
            "arch": "qwen2-0.5b", "quick": quick,
            "n_requests": n_requests, "replicas": 3,
            "backend": "LocalProcessBackend",
            "killed_replica": killed_name,
            "requests_completed": completed,
            "failed_requests": failed,
            "salvaged_requests": len(salvaged),
            "salvage_success_rate": salvage_rate,
            "failovers": fleet["failovers"],
            "bit_identical_outputs": bit_identical,
            "wall_s": wall,
            "boot_wall_s": boot_s,
            "recovery_wall_s": recovery_wall,
            "health": fleet["health"],
            "trace_events": n_events,
            "trace_out": trace_out,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
        }
        atomic_write_json(out_path, record)

        return [
            ("fabric/kill_1_of_3_processes", wall * 1e6,
             f"{n_requests} requests over 3 worker processes, "
             f"{killed_name} SIGKILLed mid-burst: {completed} completed, "
             f"{failed} failed, {len(salvaged)} salvaged @ "
             f"{salvage_rate:.0%}, bit-identical to in-process oracle, "
             f"on {record['device']}, results -> {out_path}"),
            ("fabric/recovery", recovery_wall * 1e6,
             f"failover -> last salvaged completion: "
             f"{recovery_wall:.3f}s, merged trace ({n_events} events) "
             f"-> {trace_out}"),
        ]
    finally:
        shutdown_fabric(gw)
        shutil.rmtree(spool.parent, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="BENCH_torch_fabric.json")
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
