"""Gateway-side proxy: a remote replica that quacks like a Scheduler.

The port's copy of ``repro.serving.fabric.remote``, with the same waits:
``step_wait_s`` 2 s a step, ``boot_timeout_s`` only before the first
heartbeat.  A card worker builds its round programs before that first
heartbeat (``ReplicaWorker.serve_forever``), so no later step waits on a
capture.

:class:`RemoteScheduler` implements the exact surface
:class:`~repro_torch.serving.gateway.ReplicaGateway` drives — ``submit`` /
``step`` / ``abort`` / ``output`` / the progress-signature counters —
by exchanging mailbox messages with a worker launched through a
:class:`~repro_torch.serving.fabric.backends.SchedulerBackend`.  The
gateway's failure machinery then carries over *unchanged*:

* the progress signature is fed from heartbeat counters, so a worker
  whose heartbeats stop looks exactly like a wedged in-process replica
  and climbs the HEALTHY -> DEGRADED -> QUARANTINED ladder;
* a worker whose process dies (backend poll FAILED, or a ``failed``
  status message) raises :class:`~repro_torch.serving.faults.ReplicaCrashed`
  from ``step()`` — the gateway's fatal path, DEAD + salvage;
* heartbeats carry per-request emitted-so-far tokens, so salvage
  re-routes with ``resume_emitted`` and greedy outputs stay
  bit-identical to a fault-free run across the process boundary;
* a result arriving for a request the gateway already salvaged
  elsewhere (a slow worker racing its own failover) is dropped
  idempotently.

Quarantine auto-rejoin maps to :meth:`RemoteScheduler.respawn`: cancel
the old job, submit a fresh worker for the same spec through the same
backend — the cross-process analogue of relaunching the capsule.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.fabric.backends import (COMPLETED, FAILED,
                                                 JobHandle, SchedulerBackend,
                                                 WorkerSpec)
from repro_torch.serving.fabric.mailbox import Mailbox
from repro_torch.serving.faults import ReplicaCrashed
from repro_torch.serving.gateway import CapsuleReplica, ReplicaGateway
from repro_torch.serving.tracing import Tracer, export_jsonl


class _RemoteKVView:
    """Just enough KV surface for the gateway's rejoin bookkeeping."""
    block_size = 16
    prefix_pool = None


class _RemoteEngineView:
    """Progress counters mirrored from heartbeats; the gateway's
    ``_progress_sig`` reads these exactly like a local engine's."""

    def __init__(self):
        self.decode_steps = 0
        self.prefill_tokens_executed = 0
        self.kv = _RemoteKVView()
        self.fault_injector = None


@dataclass
class _RemoteAbortState:
    """What ``abort()`` hands the gateway's salvage loop — same fields
    it reads off a local ``_ReqState``."""
    rid: int
    emitted: List[int] = field(default_factory=list)


class RemoteScheduler:
    """Scheduler-shaped proxy over one worker job + its mailbox."""

    # surface the gateway reads but a remote replica cannot offer
    prefix_cache = None
    profiler = None
    max_admissions_per_step = None
    prefill_token_budget = None

    def __init__(self, backend: SchedulerBackend, spec: WorkerSpec, *,
                 tracer: Optional[Tracer] = None,
                 step_wait_s: float = 2.0,
                 boot_timeout_s: float = 180.0,
                 poll_interval_s: float = 0.01):
        self.backend = backend
        self.spec = spec
        self.mailbox = Mailbox(spec.spool, spec.replica)
        self.tracer = tracer or Tracer(name=spec.replica)
        self.engine = _RemoteEngineView()
        self.fault_injector = None
        self.preemptions = 0
        # a synchronous backend's worker only progresses inside poll(),
        # so waiting wall-clock time for it would deadlock
        self.step_wait_s = 0.0 if backend.synchronous else step_wait_s
        self.boot_timeout_s = 0.0 if backend.synchronous else boot_timeout_s
        self.poll_interval_s = poll_interval_s
        self._next_rid = 0
        self._requests: Dict[int, Request] = {}     # outstanding, by rid
        self.queue: Dict[int, Request] = {}
        self.active: Dict[int, Request] = {}
        self.prefilling: Dict[int, Request] = {}
        self.done: Dict[int, np.ndarray] = {}
        self._emitted: Dict[int, List[int]] = {}
        self._first_token_seen: set = set()
        self._hb_seq = -1
        self._worker_exited = False
        self._draining = False
        self.handle: JobHandle = backend.submit(spec)

    # -- scheduler surface ---------------------------------------------------

    @property
    def name(self) -> str:
        return self.spec.replica

    @property
    def load(self) -> int:
        return len(self.queue) + len(self.active) + len(self.prefilling)

    @property
    def has_work(self) -> bool:
        return bool(self._requests)

    @property
    def metrics(self):
        return self.tracer.metrics

    @property
    def draining(self) -> bool:
        return self._draining

    @draining.setter
    def draining(self, value: bool) -> None:
        value = bool(value)
        if value and not self._draining:
            self.mailbox.post_to_worker("drain")
        self._draining = value

    def prefix_match_len(self, prompt) -> int:
        # no cross-process prefix introspection: remote replicas route
        # by hash ownership / least load only
        return 0

    def submit(self, request: Request, *,
               resume_emitted: Optional[List[int]] = None,
               retry: bool = False,
               admit_while_draining: bool = False) -> int:
        if self._draining and not admit_while_draining:
            raise RuntimeError(f"{self.name} is draining")
        if request.encoder_input is not None:
            raise TypeError(
                "the fabric mailbox transport does not carry encoder "
                "inputs; route enc-dec requests to in-process replicas")
        rid = self._next_rid
        self._next_rid += 1
        p = request.params
        self.mailbox.post_to_worker(
            "submit", rid=rid,
            prompt=[int(t) for t in np.asarray(request.prompt)],
            params={"temperature": float(p.temperature),
                    "greedy": bool(p.greedy),
                    "max_new_tokens": int(p.max_new_tokens),
                    "eos_token": (int(p.eos_token)
                                  if p.eos_token is not None else None)},
            tenant=request.tenant,
            resume_emitted=[int(t) for t in (resume_emitted or [])],
            retry=retry)
        self._requests[rid] = request
        self.queue[rid] = request
        if resume_emitted:
            self._emitted[rid] = [int(t) for t in resume_emitted]
        self.tracer.submit(rid, request.tenant, retry=retry)
        return rid

    def step(self) -> None:
        """One gateway step: poll the backend, pump the mailbox, and —
        for asynchronous backends — wait up to ``step_wait_s`` for the
        worker to make observable progress, so the gateway's step
        cadence tracks worker cadence instead of spinning the health
        ladder on wall-clock noise.  Before the very first heartbeat
        the wait stretches to ``boot_timeout_s``: a subprocess worker
        pays interpreter + jit warmup before it can possibly speak, and
        that must not read as a health strike."""
        wait = (self.boot_timeout_s if self._hb_seq < 0
                else self.step_wait_s)
        deadline = time.monotonic() + wait
        while True:
            progressed = self._pump()
            if progressed or not self._requests:
                return
            if time.monotonic() >= deadline:
                return
            time.sleep(self.poll_interval_s)

    def _pump(self) -> bool:
        state = self.backend.poll(self.handle)
        progressed = self._pump_mailbox()
        if state == FAILED:
            raise ReplicaCrashed(
                f"{self.name}: worker job {self.handle.job_id} failed "
                f"({self.handle.error or 'no error recorded'})")
        if state == COMPLETED and self._requests:
            raise ReplicaCrashed(
                f"{self.name}: worker exited with "
                f"{len(self._requests)} request(s) outstanding")
        return progressed

    def _pump_mailbox(self) -> bool:
        progressed = False
        hb = self.mailbox.read_heartbeat()
        if hb is not None and int(hb.get("seq", 0)) != self._hb_seq:
            # a fresh heartbeat ends the step's wait loop (the worker is
            # alive and spoke); whether it counts as *health* progress
            # is the gateway's call via the progress signature
            progressed = True
            self._hb_seq = int(hb.get("seq", 0))
            eng = self.engine
            eng.decode_steps = int(hb.get("decode_steps", 0))
            eng.prefill_tokens_executed = int(hb.get("prefill_tokens", 0))
            self.preemptions = int(hb.get("preemptions", 0))
            stages = {rid: "queued" for rid in self._requests}
            for stage in ("active", "prefilling"):
                for rid in hb.get(stage, []):
                    if int(rid) in stages:
                        stages[int(rid)] = stage
            self.queue.clear()
            self.active.clear()
            self.prefilling.clear()
            buckets = {"queued": self.queue, "active": self.active,
                       "prefilling": self.prefilling}
            for rid, stage in stages.items():
                buckets[stage][rid] = self._requests[rid]
            for rid_s, toks in (hb.get("emitted") or {}).items():
                rid = int(rid_s)
                if rid in self._requests:
                    self._emitted[rid] = [int(t) for t in toks]
                    if toks and rid not in self._first_token_seen:
                        self._first_token_seen.add(rid)
                        self.tracer.first_token(rid)
        for msg in self.mailbox.collect_outbox():
            if msg["kind"] == "result":
                rid = int(msg["rid"])
                if rid not in self._requests:
                    continue       # duplicate / already-salvaged: no-op
                tokens = np.asarray(msg.get("tokens", []), np.int32)
                self.done[rid] = tokens
                self._forget(rid)
                if rid not in self._first_token_seen:
                    self._first_token_seen.add(rid)
                    self.tracer.first_token(rid)
                self.tracer.retire(rid, len(tokens), "complete")
                progressed = True
            elif msg["kind"] == "status":
                self._worker_exited = True
                if msg.get("state") == "failed":
                    raise ReplicaCrashed(
                        f"{self.name}: worker reported failure: "
                        f"{msg.get('error', '')}")
        return progressed

    def _forget(self, rid: int) -> None:
        self._requests.pop(rid, None)
        self.queue.pop(rid, None)
        self.active.pop(rid, None)
        self.prefilling.pop(rid, None)
        self._emitted.pop(rid, None)

    def output(self, rid: int) -> np.ndarray:
        return self.done[rid]

    def abort(self) -> List[_RemoteAbortState]:
        """Salvage: hand back every outstanding request with its
        last-heartbeat emitted tokens, then forget them — late results
        from a still-twitching worker are dropped idempotently."""
        states = [_RemoteAbortState(rid, list(self._emitted.get(rid, [])))
                  for rid in sorted(self._requests)]
        for st in states:
            self._forget(st.rid)
        return states

    # -- lifecycle -----------------------------------------------------------

    def respawn(self, draining: bool = False) -> "RemoteScheduler":
        """Quarantine-exit relaunch: cancel the old job, clear the dead
        worker's spool leavings, submit a fresh worker for the same
        spec.  Returns self — the gateway swaps it in as the replica's
        scheduler, rid numbering and finished outputs carried over."""
        self.backend.cancel(self.handle)
        for box in (self.mailbox.inbox, self.mailbox.outbox):
            for path in box.glob("*.json"):
                path.unlink()
        for leftover in (self.mailbox.heartbeat_path,
                         self.mailbox.home / "status.json"):
            if leftover.exists():
                leftover.unlink()
        self._hb_seq = -1
        self._worker_exited = False
        self.handle = self.backend.submit(self.spec)
        self._draining = False
        if draining:
            self.draining = True
        return self

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop the worker: post stop, give it a moment to exit clean
        (status + trace export), then cancel through the backend."""
        self.mailbox.post_to_worker("stop")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            state = self.backend.poll(self.handle)
            if state in (COMPLETED, FAILED):
                return
            if not self.backend.synchronous:
                time.sleep(self.poll_interval_s)
        self.backend.cancel(self.handle)


# ---------------------------------------------------------------------------
# fleet launch / teardown
# ---------------------------------------------------------------------------

def launch_fabric_replicas(
        n: int, backend: SchedulerBackend, spool, *,
        model_spec: Optional[Dict[str, Any]] = None,
        image_dir: Optional[str] = None, partition: str = "general",
        tracing: bool = False, step_wait_s: float = 2.0,
        **gateway_kw) -> ReplicaGateway:
    """Launch ``n`` replica workers through ``backend`` and front them
    with a :class:`ReplicaGateway` — the cross-process analogue of
    :func:`~repro_torch.serving.gateway.launch_capsule_replicas`.  Capacity
    is validated per worker before submit (CapacityError aborts the
    whole launch), and each replica records its backend/job bookkeeping
    where the in-process launcher records ch-run's."""
    if n <= 0:
        raise ValueError(f"need at least one replica, got n={n}")
    spool = Path(spool)
    replicas = []
    for r in range(n):
        name = f"replica{r}"
        spec = WorkerSpec(replica=name, spool=spool,
                          model_spec=model_spec, image_dir=image_dir,
                          partition=partition)
        rs = RemoteScheduler(
            backend, spec, tracer=Tracer(enabled=tracing, name=name),
            step_wait_s=step_wait_s)
        replicas.append(CapsuleReplica(
            name, rs,
            capsule={"backend": type(backend).__name__,
                     "job_id": rs.handle.job_id, "partition": partition,
                     "spool": str(spool)}))
    return ReplicaGateway(replicas, **gateway_kw)


def shutdown_fabric(gateway: ReplicaGateway,
                    timeout_s: float = 30.0) -> None:
    """Stop every remote replica's worker (in-process replicas are
    untouched)."""
    for rep in gateway.replicas:
        if isinstance(rep.scheduler, RemoteScheduler):
            rep.scheduler.shutdown(timeout_s)


def collect_fabric_traces(gateway: ReplicaGateway, spool,
                          out_path) -> int:
    """Merge the fleet's gateway-side events with every worker-side
    trace file the workers exported into one replica-stamped JSONL, and
    return the merged event count.  Worker clocks are per-process
    monotonic — events still sort by ``ts``, but cross-process ordering
    is only meaningful per replica, which is how the fleet report reads
    them."""
    import json as _json
    events: List[Dict[str, Any]] = list(gateway.trace_events())
    for home in sorted(Path(spool).iterdir()):
        trace = home / "trace.jsonl"
        if not trace.is_file():
            continue
        with trace.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(_json.loads(line))
    events.sort(key=lambda ev: (ev.get("replica", ""), ev["ts"]))
    export_jsonl(events, out_path)
    return len(events)
