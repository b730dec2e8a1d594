"""Request-lifecycle tracing + engine timeline for the serving stack.

The source paper's deployments run inside network-isolated capsules on
secure HPC systems: no Prometheus endpoint to scrape, no Jaeger
collector to push to.  All observability therefore has to be
**file-based and self-contained** — a structured event log the operator
copies out of the allocation and inspects offline.  This module is that
subsystem, and it answers the question ``metrics.py``'s endpoint
aggregates cannot: not "what was p95 TTFT" but "*why* did request 17
stall for 40 steps" — was it an ``OutOfBlocks`` admission stall, a
recompute preemption, a cold prefix probe, or a replica whose prefill
budget sat idle.

Three layers:

* :class:`Tracer` — one per scheduler/replica.  Typed events (kinds in
  :data:`EVENT_KINDS`) appended to a bounded ring buffer
  (``buffer_events`` deep; oldest events drop first, ``dropped_events``
  counts them) with a shared monotonic clock.  **The tracer owns the
  replica's** :class:`~repro_torch.serving.metrics.ServingMetrics` **and
  feeds it**: the scheduler records through tracer methods only, so
  there is exactly one recording path whether tracing is on or off.
  Off-by-default: a disabled tracer forwards to the metrics counters
  and skips event construction entirely — the hot-loop cost is one
  ``if self.enabled`` per call site.

* **Per-request spans** — ``submit`` → (``route``) → ``prefix_probe`` →
  ``admit`` (or ``admission_stall``) → one ``prefill_advance`` per
  chunk round the row executed (with executed-token counts) →
  ``first_token`` → one ``decode`` per decode step → any
  ``preempt`` / re-``admit`` (``resumed=True``) cycles → ``retire``.
  Engine-side events carry slot ids; the tracer resolves them to
  request ids through the slot bindings the scheduler registers, so a
  span reads as one request even as it migrates across slots.

* **Engine step timeline** — one ``engine_step`` event per
  ``Scheduler.step()`` with the phase breakdown (admission /
  prefill-advance / decode dispatch / sample+retire, in seconds) and a
  gauges snapshot: free KV blocks, free slots, pinned prefix blocks,
  in-flight prefill cursors, queue depth, live sequences.

Exporters (files only, per the no-external-systems constraint):

* :meth:`Tracer.export_jsonl` / :func:`export_jsonl` — one JSON object
  per line; the schema every event obeys (checked by
  ``scripts/trace_report.py --validate``) is ``ts`` (float seconds,
  monotonic), ``kind`` (from :data:`EVENT_KINDS`), ``step`` (int; every
  event carries the engine step it happened in) and — for
  request-scoped kinds — ``rid``.
* :func:`to_chrome_trace` / :func:`export_chrome_trace` — Chrome
  trace-event format, loads directly in Perfetto or
  ``chrome://tracing``: each replica is a *process*, request spans are
  async lanes (``b``/``e`` with per-event ``n`` instants), engine-step
  phases are complete slices on an "engine" thread, and free-block /
  queue-depth gauges are counter tracks.
* :func:`merge_traces` — gateway-level merge: interleaves N replicas'
  ring buffers on the shared clock (every tracer in one gateway uses
  the same ``clock``), stamping each event with its replica name, so a
  cross-replica routing decision and the admission it caused line up in
  one timeline.
"""
from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.slo import SLOMonitor

# Fault-tolerance vocabulary: replica membership transitions,
# failover/retry bookkeeping, and the degradation ladder.  Split out so
# ``scripts/trace_report.py --faults`` and the lint rule can name the
# family; unioned into EVENT_KINDS below.
FAULT_EVENT_KINDS = frozenset({
    "replica_health",    # health state transition (edge-triggered)
    "replica_failover",  # a dead/quarantined replica's work was salvaged
    "replica_retry",     # one salvaged request re-submitted elsewhere
    "replica_rejoin",    # quarantine exit: capsule relaunched, cache warm
    "request_failed",    # typed terminal failure (retry budget exhausted)
    "overload_shed",     # degradation ladder engaged/released (edge)
    "overload_cap",      # a request's max_new_tokens capped under load
})

# The documented event enum.  ``scripts/trace_report.py --validate``
# imports this set: an event whose ``kind`` is not listed here fails the
# schema check, so growing the vocabulary is an explicit, reviewed act.
EVENT_KINDS = frozenset({
    # request lifecycle
    "submit",            # rid entered a scheduler's queue
    "route",             # gateway picked a replica (reason + match len)
    "prefix_probe",      # admission-time radix lookup (hit/cached_len)
    "admit",             # slot claimed, cursor registered (resumed flag)
    "admission_stall",   # head-of-queue could not admit (OutOfBlocks)
    "prefill_advance",   # one chunk round's executed tokens for one row
    "first_token",       # prompt complete, first sample emitted
    "decode",            # one decode-step token for a live row
    "preempt",           # recompute preemption (mid_prefill flag)
    "retire",            # finished: tokens + reason
    # KV ledger
    "block_alloc",       # admission claimed blocks for a slot
    "block_grow",        # decode grew a slot by one block
    "block_free",        # slot retired, blocks back on the ring
    "out_of_blocks",     # pool dry (context: where it was hit)
    # prefix cache
    "prefix_insert",     # freshly prefilled prompt indexed into the tree
    "prefix_evict",      # LRU eviction freed blocks/nodes
    # engine timeline
    "engine_step",       # one Scheduler.step(): phases + gauges
    # observatory: SLO + compilation telemetry
    "slo_breach",        # a tenant's policy check changed state
    "recompile",         # a jitted program saw a novel shape signature
}) | FAULT_EVENT_KINDS

# kinds that must carry a request id (the rest are step-scoped;
# prefill_advance / block events resolve rids through slot bindings and
# legitimately fall back to step scope when the engine is driven raw)
_RID_KINDS = frozenset({
    "submit", "route", "prefix_probe", "admit",
    "first_token", "decode", "preempt", "retire",
    "replica_retry", "request_failed", "overload_cap",
})

DEFAULT_BUFFER_EVENTS = 65536


class Tracer:
    """Per-replica event recorder that feeds the metrics counters.

    ``enabled=False`` (the default) keeps only the metrics path live:
    every recording method still forwards to :attr:`metrics`, but no
    event objects are built — the overhead over the pre-tracing code is
    one attribute check per call.  All tracers behind one gateway must
    share ``clock`` (they do by default: ``time.perf_counter`` is the
    process-wide monotonic clock) so :func:`merge_traces` can interleave
    them.
    """

    def __init__(self, metrics: Optional[ServingMetrics] = None, *,
                 enabled: bool = False,
                 buffer_events: int = DEFAULT_BUFFER_EVENTS,
                 clock=time.perf_counter, name: str = "replica0",
                 slo: Optional[SLOMonitor] = None):
        if buffer_events <= 0:
            raise ValueError(
                f"buffer_events must be positive, got {buffer_events}")
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.slo = slo
        self.enabled = enabled
        self.clock = clock
        self.name = name
        self.events: deque = deque(maxlen=buffer_events)
        self.buffer_events = buffer_events
        self.emitted_events = 0            # incl. any the ring dropped
        self.current_step = 0              # stamped on every event
        self._slot_rid: Dict[int, int] = {}   # engine-side rid resolution

    @property
    def dropped_events(self) -> int:
        return self.emitted_events - len(self.events)

    # -- plumbing ------------------------------------------------------------

    def _emit(self, kind: str, rid: int = -1, **data) -> None:
        ev = {"ts": self.clock(), "kind": kind, "step": self.current_step}
        if rid >= 0:
            ev["rid"] = rid
        if data:
            ev.update(data)
        self.events.append(ev)
        self.emitted_events += 1

    def bind_slot(self, slot: int, rid: int) -> None:
        """Register slot -> rid so engine/kv events resolve to a span."""
        self._slot_rid[slot] = rid

    def unbind_slot(self, slot: int) -> None:
        self._slot_rid.pop(slot, None)

    def rid_of_slot(self, slot: int) -> int:
        return self._slot_rid.get(slot, -1)

    # -- request lifecycle (metrics-feeding sites first) ---------------------

    def submit(self, rid: int, tenant: str = "default",
               retry: bool = False) -> None:
        """``retry=True`` marks a failover re-submission: the metrics
        record a retry counter instead of a second logical submit, so
        merged fleet summaries count the request once (the ``retry``
        flag is only stamped on retry events, keeping pre-existing
        traces byte-identical)."""
        self.metrics.record_submit(rid, tenant, retry=retry)
        if self.enabled:
            if retry:
                self._emit("submit", rid, tenant=tenant, retry=True)
            else:
                self._emit("submit", rid, tenant=tenant)

    def first_token(self, rid: int) -> None:
        self.metrics.record_first_token(rid)
        if self.enabled:
            self._emit("first_token", rid)

    def retire(self, rid: int, n_tokens: int, reason: str) -> None:
        self.metrics.record_finish(rid, n_tokens, reason)
        if self.enabled:
            self._emit("retire", rid, n_tokens=n_tokens, reason=reason)

    def prefix_probe(self, rid: int, cached_len: int, prompt_len: int,
                     count: bool = True) -> None:
        """Admission-time prefix outcome.  ``count=False`` suppresses
        the metrics update (a resumed request's re-probe is a real trace
        event but must not double-count the per-request hit/miss)."""
        if count:
            self.metrics.record_prefix(cached_len, prompt_len)
        if self.enabled:
            self._emit("prefix_probe", rid, cached_len=cached_len,
                       prompt_len=prompt_len, hit=cached_len > 0)

    def prefill_work(self, real: int, executed: int) -> None:
        self.metrics.record_prefill_work(real, executed)

    def budget_round(self, executed: int, budget: int) -> None:
        self.metrics.record_budget(executed, budget)

    def decode_tokens(self, rids) -> None:
        """One decode step emitted tokens for ``rids`` (per-tenant
        inter-token gap recording; metrics-only, no event)."""
        self.metrics.record_decode_tokens(rids)

    def check_slo(self) -> None:
        """Evaluate SLO policies against current per-tenant stats and
        emit one ``slo_breach`` event per state transition (enter-breach
        or recover).  Cheap when nothing changed; no-op without a
        monitor.  Breach totals accumulate on the monitor even when the
        tracer is disabled — policy accounting is not trace-gated."""
        if self.slo is None:
            return
        for t in self.slo.evaluate(self.metrics.tenants):
            if self.enabled:
                self._emit("slo_breach", tenant=t["tenant"],
                           metric=t["metric"], observed=t["observed"],
                           threshold=t["threshold"],
                           recovered=t["recovered"])

    # -- trace-only events ---------------------------------------------------

    def route(self, rid: int, replica: str, reason: str, match_len: int,
              load: int) -> None:
        if self.enabled:
            self._emit("route", rid, replica=replica, reason=reason,
                       match_len=match_len, load=load)

    def admit(self, rid: int, slot: int, seq_len: int, cached_len: int,
              resumed: bool) -> None:
        # queue wait (submit -> first admit) per request/tenant; the
        # metrics ignore re-admits after preemption
        self.metrics.record_admit(rid)
        if self.enabled:
            self._emit("admit", rid, slot=slot, seq_len=seq_len,
                       cached_len=cached_len, resumed=resumed)

    def admission_stall(self, reason: str, queue_depth: int,
                        rid: int = -1) -> None:
        if self.enabled:
            self._emit("admission_stall", rid, reason=reason,
                       queue_depth=queue_depth)

    def prefill_advance(self, slot: int, executed: int, pos: int,
                        total: int) -> None:
        """One chunk round's progress for one in-flight row (engine)."""
        if self.enabled:
            self._emit("prefill_advance", self.rid_of_slot(slot), slot=slot,
                       executed=executed, pos=pos, total=total)

    def decode(self, rid: int, pos: int, token: int) -> None:
        if self.enabled:
            self._emit("decode", rid, pos=pos, token=token)

    def preempt(self, rid: int, mid_prefill: bool) -> None:
        if self.enabled:
            self._emit("preempt", rid, mid_prefill=mid_prefill)

    # -- KV ledger -----------------------------------------------------------

    def block_alloc(self, slot: int, n_blocks: int, available: int) -> None:
        if self.enabled:
            self._emit("block_alloc", self.rid_of_slot(slot), slot=slot,
                       n_blocks=n_blocks, available=available)

    def block_grow(self, slot: int, available: int) -> None:
        if self.enabled:
            self._emit("block_grow", self.rid_of_slot(slot), slot=slot,
                       available=available)

    def block_free(self, slot: int, n_blocks: int, available: int) -> None:
        if self.enabled:
            self._emit("block_free", self.rid_of_slot(slot), slot=slot,
                       n_blocks=n_blocks, available=available)

    def out_of_blocks(self, context: str, slot: int = -1) -> None:
        if self.enabled:
            self._emit("out_of_blocks", self.rid_of_slot(slot),
                       context=context, slot=slot)

    # -- prefix cache --------------------------------------------------------

    def prefix_insert(self, slot: int, tokens_cached: int,
                      blocks: int) -> None:
        if self.enabled:
            self._emit("prefix_insert", self.rid_of_slot(slot), slot=slot,
                       tokens_cached=tokens_cached, blocks=blocks)

    def prefix_evict(self, blocks: int, nodes: int) -> None:
        if self.enabled:
            self._emit("prefix_evict", blocks=blocks, nodes=nodes)

    # -- compilation telemetry -----------------------------------------------

    def recompile(self, program: str, signature: str, compiles: int,
                  post_warm: bool) -> None:
        """A jitted program compiled a novel shape signature beyond its
        first (or any signature after warmup) — the shape-churn warning
        :class:`~repro_torch.serving.profiling.RecompilationTracker` raises."""
        if self.enabled:
            self._emit("recompile", program=program, signature=signature,
                       compiles=compiles, post_warm=post_warm)

    # -- fault tolerance ------------------------------------------------------

    def replica_health(self, replica: str, old: str, new: str,
                       reason: str, consecutive_bad: int) -> None:
        """One edge-triggered membership transition (HEALTHY ->
        DEGRADED -> QUARANTINED / DEAD and back)."""
        if self.enabled:
            self._emit("replica_health", replica=replica, old=old,
                       new=new, reason=reason,
                       consecutive_bad=consecutive_bad)

    def failover(self, replica: str, salvaged_inflight: int,
                 salvaged_queued: int, reason: str) -> None:
        """A replica left the routable set and the gateway harvested
        its queued + in-flight requests for re-routing."""
        if self.enabled:
            self._emit("replica_failover", replica=replica,
                       salvaged_inflight=salvaged_inflight,
                       salvaged_queued=salvaged_queued, reason=reason)

    def retry(self, rid: int, attempt: int, backoff_steps: int,
              prev_replica: str) -> None:
        """One salvaged request re-submitted on this replica (``rid`` is
        its rid *here*; the submit/finish counters are handled by
        ``submit(retry=True)``, this is the trace-side marker)."""
        if self.enabled:
            self._emit("replica_retry", rid, attempt=attempt,
                       backoff_steps=backoff_steps,
                       prev_replica=prev_replica)

    def rejoin(self, replica: str, rejoins: int,
               warm_prefix_blocks: int) -> None:
        """Quarantine exit: the capsule relaunched; its engine-held
        prefix cache survived, so re-routed prompts probe warm."""
        if self.enabled:
            self._emit("replica_rejoin", replica=replica, rejoins=rejoins,
                       warm_prefix_blocks=warm_prefix_blocks)

    def request_failed(self, rid: int, reason: str, attempts: int) -> None:
        """Terminal typed failure: the request exhausted its retry
        budget (or had no replica left).  Feeds the failure counters —
        a failed request is *not* a completed one."""
        self.metrics.record_failed(reason)
        if self.enabled:
            self._emit("request_failed", rid, reason=reason,
                       attempts=attempts)

    def shed(self, tenant: str) -> None:
        """A submit was rejected (``Overloaded``) while degraded.  There
        is no rid (admission never happened) so this is metrics-only."""
        self.metrics.record_shed(tenant)

    def overload(self, active: bool, reason: str,
                 queue_depth: int) -> None:
        """Degradation-ladder edge: engaged (``active=True``) or
        released.  One event per transition, like ``slo_breach``."""
        if self.enabled:
            self._emit("overload_shed", active=active, reason=reason,
                       queue_depth=queue_depth, recovered=not active)

    def overload_cap(self, rid: int, tenant: str, orig_max_new: int,
                     capped_max_new: int) -> None:
        """An over-budget tenant's request had max_new_tokens capped
        while the fleet was degraded."""
        if self.enabled:
            self._emit("overload_cap", rid, tenant=tenant,
                       orig_max_new=orig_max_new,
                       capped_max_new=capped_max_new)

    # -- engine timeline -----------------------------------------------------

    def engine_step(self, *, decoded: bool, queue_depth: int, active: int,
                    max_slots: int, admitted: int, completed: int,
                    prefill_executed: int, budget: Optional[int],
                    dur_admit_s: float, dur_prefill_s: float,
                    dur_decode_s: float, dur_sample_s: float,
                    free_blocks: int, free_slots: int, inflight: int,
                    prefix_pins: int) -> None:
        """Close one scheduler step: gauge sampling (decode steps only —
        the pre-tracing metrics semantics) plus the timeline event."""
        if decoded:
            self.metrics.sample_gauges(queue_depth, active, max_slots)
        if self.enabled:
            self._emit("engine_step", decoded=decoded,
                       queue_depth=queue_depth, active=active,
                       admitted=admitted, completed=completed,
                       prefill_executed=prefill_executed,
                       budget=budget if budget is not None else 0,
                       dur_admit_s=dur_admit_s,
                       dur_prefill_s=dur_prefill_s,
                       dur_decode_s=dur_decode_s,
                       dur_sample_s=dur_sample_s,
                       free_blocks=free_blocks, free_slots=free_slots,
                       inflight=inflight, prefix_pins=prefix_pins)
        self.current_step += 1

    # -- export --------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """The buffered events, oldest first (copies — safe to mutate)."""
        return [dict(ev) for ev in self.events]

    def export_jsonl(self, path) -> Path:
        return export_jsonl(self.snapshot(), path, replica=self.name)


# ---------------------------------------------------------------------------
# file exporters
# ---------------------------------------------------------------------------

def export_jsonl(events: Iterable[Mapping], path,
                 replica: Optional[str] = None) -> Path:
    """One JSON object per line.  ``replica`` stamps events that do not
    carry one already (merged streams do)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for ev in events:
            if replica is not None and "replica" not in ev:
                ev = {**ev, "replica": replica}
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return path


def merge_traces(tracers: Sequence[Tracer]) -> List[dict]:
    """Gateway-level merge: interleave N replicas' buffers on the shared
    clock, each event stamped with its replica name.  The result is a
    single fleet-wide timeline — a ``route`` decision on one replica and
    the ``admit`` it produced sort adjacently by ``ts``."""
    merged: List[dict] = []
    for tr in tracers:
        for ev in tr.events:
            merged.append({**ev, "replica": tr.name})
    merged.sort(key=lambda ev: ev["ts"])
    return merged


def _span_bounds(evs: List[dict]) -> Dict[int, List[dict]]:
    by_rid: Dict[int, List[dict]] = {}
    for ev in evs:
        rid = ev.get("rid", -1)
        if rid >= 0:
            by_rid.setdefault(rid, []).append(ev)
    return by_rid


def to_chrome_trace(events_by_replica: Mapping[str, Sequence[Mapping]]
                    ) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing).

    Layout: one *process* per replica; request spans as async lanes
    (``b``/``e`` pairs keyed by a per-replica string id, with ``n``
    instants for every intra-span event); engine-step phases as ``X``
    complete slices on an "engine" thread; free-block and queue-depth
    gauges as counter tracks.  Timestamps are microseconds relative to
    the earliest event across all replicas (the shared clock).
    """
    all_ts = [ev["ts"] for evs in events_by_replica.values() for ev in evs]
    t0 = min(all_ts) if all_ts else 0.0

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    out: List[dict] = []
    for pid, (replica, evs) in enumerate(sorted(events_by_replica.items())):
        evs = sorted(evs, key=lambda e: e["ts"])
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": replica}})
        out.append({"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                    "args": {"name": "requests"}})
        out.append({"ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
                    "args": {"name": "engine"}})
        for rid, revs in sorted(_span_bounds(evs).items()):
            span_id = f"{replica}/req{rid}"
            name = f"req {rid}"
            # open at the first event of the span (submit unless the
            # ring dropped it), close at the last (retire when complete)
            base = {"cat": "request", "name": name, "id": span_id,
                    "pid": pid, "tid": 0}
            out.append({**base, "ph": "b", "ts": us(revs[0]["ts"])})
            for ev in revs:
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "rid")}
                out.append({**base, "ph": "n", "ts": us(ev["ts"]),
                            "args": args})
            out.append({**base, "ph": "e", "ts": us(revs[-1]["ts"])})
        for ev in evs:
            if ev["kind"] in ("slo_breach", "recompile", "replica_health",
                              "replica_failover", "replica_rejoin",
                              "overload_shed"):
                # step-scoped warnings: instants on the engine thread so
                # they line up with the phase slices they interrupt
                # (rid-carrying fault kinds — replica_retry,
                # request_failed, overload_cap — flow into their request
                # lanes via the span builder above instead)
                out.append({"ph": "i", "s": "t", "cat": "observatory",
                            "name": ev["kind"], "pid": pid, "tid": 1,
                            "ts": us(ev["ts"]),
                            "args": {k: v for k, v in ev.items()
                                     if k != "ts"}})
                continue
            if ev["kind"] != "engine_step":
                continue
            end = ev["ts"]
            phases = [("sample", ev.get("dur_sample_s", 0.0)),
                      ("decode", ev.get("dur_decode_s", 0.0)),
                      ("prefill", ev.get("dur_prefill_s", 0.0)),
                      ("admit", ev.get("dur_admit_s", 0.0))]
            for name, dur in phases:       # walk backwards from step end
                if dur <= 0.0:
                    continue
                out.append({"ph": "X", "cat": "engine", "name": name,
                            "pid": pid, "tid": 1,
                            "ts": us(end - dur), "dur": dur * 1e6,
                            "args": {"step": ev["step"]}})
                end -= dur
            out.append({"ph": "C", "pid": pid, "name": "free_blocks",
                        "ts": us(ev["ts"]),
                        "args": {"free_blocks": ev.get("free_blocks", 0)}})
            out.append({"ph": "C", "pid": pid, "name": "queue_depth",
                        "ts": us(ev["ts"]),
                        "args": {"queue_depth": ev.get("queue_depth", 0)}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(events_by_replica: Mapping[str, Sequence[Mapping]],
                        path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome_trace(events_by_replica)) + "\n")
    return path


# ---------------------------------------------------------------------------
# schema validation (shared with scripts/trace_report.py)
# ---------------------------------------------------------------------------

def validate_event(ev: Mapping) -> Optional[str]:
    """Schema check for one event dict; returns an error string or None.

    Every event must carry a numeric ``ts``, a ``kind`` from
    :data:`EVENT_KINDS`, and an integer ``step`` and/or ``rid``;
    request-scoped kinds must carry ``rid``."""
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        return f"bad ts: {ts!r}"
    kind = ev.get("kind")
    if kind not in EVENT_KINDS:
        return f"unknown kind: {kind!r}"
    has_rid = isinstance(ev.get("rid"), int) and ev["rid"] >= 0
    has_step = isinstance(ev.get("step"), int) and ev["step"] >= 0
    if not (has_rid or has_step):
        return f"{kind}: neither rid nor step present"
    if kind in _RID_KINDS and not has_rid:
        return f"{kind}: request-scoped kind without rid"
    return None
