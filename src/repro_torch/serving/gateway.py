"""Multi-replica serving gateway: routing, health, failover, drain.

The port's copy of ``repro.serving.gateway``: the same routing, health
ladder, failover, retry, degradation, drain and watchdog, line for line
over the port's scheduler.  On the card the replicas of one process share
one set of parameter tensors (each engine keeps the tensors it is given
when they already lie on its device), and each engine keeps its own KV
cache and its own captured round programs.  Salvage frees slots, blocks
and prefix pins through ``Scheduler.abort()``, which touches no program's
static buffers: the block table is refreshed in place every round and the
dense staging stripe stays where it is.

Scale-out layer of the serving story.  Each replica is one
:class:`~repro_torch.serving.scheduler.Scheduler` over one engine — conceptually
one ``ch-run`` capsule instance of the same immutable image, the way the
paper's deployment runs one containerized process per allocation.  The
gateway front-ends N replicas:

* ``submit`` routes with *prefix affinity*: the request goes to the
  replica whose prefix cache holds the longest prefix of its prompt
  (ties and misses broken by least load).  When no replica has the
  prefix yet, the first block of token ids is hashed to pick a stable
  owner — so every request opening with the same system prompt lands on
  the same capsule and warms a single cache instead of N — unless that
  owner is overloaded by more than ``affinity_slack`` requests relative
  to the least-loaded replica, in which case load wins;
* ``step`` advances every *routable* replica one decode round and feeds
  each replica's :class:`~repro_torch.serving.health.HealthMonitor` with the
  one signal a wedged capsule cannot fake: whether the scheduler's
  observable state actually changed (progress signature);
* ``drain`` closes admission and runs every replica until all in-flight
  requests complete or fail over — the graceful-shutdown path a rolling
  image update needs (the capsule is immutable, so an update is drain +
  relaunch).

Failure handling — nodes fail and batch schedulers preempt
allocations on the paper's systems, so the fleet must survive a replica:

* **Health membership.**  HEALTHY -> DEGRADED -> QUARANTINED (salvage +
  optional auto-rejoin after a cooldown) or -> DEAD (a crashed capsule;
  terminal).  Transitions are edge-triggered ``replica_health`` events.
* **Failover.**  A replica leaving the routable set has its queued and
  in-flight requests salvaged (``Scheduler.abort()``: slots/pins freed,
  emitted-so-far tokens kept) and re-routed to survivors under a
  per-request retry budget with exponential backoff — the resume is the
  recompute-preemption path (re-prefill prompt + emitted[:-1]), so
  greedy outputs stay bit-identical to a fault-free run.  A request that
  exhausts its budget resolves to a typed :class:`RequestFailed` from
  :meth:`result` — never a stranded handle, never a bare exception.
* **Graceful degradation.**  Under a configured
  :class:`DegradationPolicy`, sustained SLO breaches or fleet-wide
  queue exhaustion shed load (:class:`Overloaded` at submit), shrink
  every replica's ``prefill_token_budget``, and cap over-budget
  tenants' ``max_new_tokens`` — all edge-triggered ``overload_*``
  events, all restored when pressure clears.
* **Watchdog.**  ``run()``/``drain()`` raise after ``stall_patience``
  consecutive no-progress gateway steps instead of spinning forever —
  quarantine normally resolves a wedged replica long before that.

``launch_capsule_replicas`` builds the engines *inside* ``ch-run``
launches via :class:`~repro_torch.core.container.CapsuleRuntime`, recording the
per-replica capsule bookkeeping (image, uid map, scrubbed env) on the
handle; unit tests may also construct replicas from bare engines.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.spans import SPANS
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan, ReplicaCrashed
from repro_torch.serving.health import (DEAD, HEALTHY, QUARANTINED,
                                        HealthConfig, HealthMonitor)
from repro_torch.serving.metrics import merge_summaries
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.tracing import (Tracer, export_jsonl,
                                         export_chrome_trace, merge_traces)


class Overloaded(RuntimeError):
    """Submit rejected: the fleet is shedding load (degraded mode) or
    has no routable replica left.  Typed so callers can back off and
    retry instead of treating it as a server bug."""


@dataclass
class RequestFailed:
    """Terminal typed failure returned by :meth:`ReplicaGateway.result`
    for a request that exhausted its retry budget (or had no replica
    left to retry on).  A value, not an exception: drain() resolves
    every handle to either tokens or one of these."""
    handle: Tuple[int, int]
    rid: int                       # rid on the last replica that held it
    reason: str
    attempts: int
    last_error: str = ""


@dataclass(frozen=True)
class RetryPolicy:
    """Per-request failover budget.  Backoff is measured in *gateway
    steps* (the scheduler's unit of time): retry ``i`` waits
    ``backoff_base_steps * backoff_factor**(i-1)`` steps before
    re-routing, so a flapping fleet is not hammered."""
    max_retries: int = 3
    backoff_base_steps: int = 1
    backoff_factor: int = 2

    def backoff_steps(self, attempt: int) -> int:
        return self.backoff_base_steps * self.backoff_factor ** max(
            attempt - 1, 0)


@dataclass(frozen=True)
class DegradationPolicy:
    """When and how the gateway sheds load instead of collapsing.

    Degraded mode *arms* when the fleet queue depth reaches
    ``shed_queue_depth`` (immediately — pool exhaustion is not a trend)
    or when any tenant's SLO breach stays active for ``breach_steps``
    consecutive gateway steps; it *releases* after ``recover_steps``
    consecutive clear steps.  While degraded: submits past the shed
    depth raise :class:`Overloaded`, every replica's
    ``prefill_token_budget`` is shrunk by ``budget_shrink`` (restored
    on release), and requests from tenants in active breach get
    ``max_new_tokens`` capped at ``max_new_cap``."""
    shed_queue_depth: Optional[int] = None
    breach_steps: int = 16
    recover_steps: int = 8
    budget_shrink: float = 0.5
    max_new_cap: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.budget_shrink <= 1.0:
            raise ValueError(
                f"budget_shrink must be in (0, 1], got {self.budget_shrink}")
        if self.breach_steps <= 0 or self.recover_steps <= 0:
            raise ValueError("breach/recover step thresholds must be "
                             "positive")


@dataclass
class CapsuleReplica:
    """One serving replica + its launch bookkeeping."""
    name: str
    scheduler: Scheduler
    capsule: Optional[Dict[str, Any]] = None   # image/uid_map/env of ch-run
    routed: int = 0

    @property
    def load(self) -> int:
        return self.scheduler.load


@dataclass
class _GatewayRequest:
    """Gateway-side request record: survives replica failures (the
    scheduler-side state dies with its replica)."""
    handle: Tuple[int, int]            # the (replica, rid) submit returned
    request: Request
    current: Tuple[int, int]           # where it lives NOW
    attempts: int = 0
    emitted: List[int] = field(default_factory=list)   # salvaged tokens
    output: Optional[np.ndarray] = None
    failed: Optional[RequestFailed] = None
    last_error: str = ""


class ReplicaGateway:
    """Prefix-affine, load-balanced, health-checked router over N
    replicas."""

    def __init__(self, replicas: List[CapsuleReplica],
                 affinity_slack: int = 2,
                 health: Optional[HealthConfig] = None,
                 retry: Optional[RetryPolicy] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 stall_patience: int = 64):
        if not replicas:
            raise ValueError("gateway needs at least one replica")
        self.replicas = replicas
        self.affinity_slack = affinity_slack
        self.draining = False
        self.health_config = health or HealthConfig()
        self.health = [HealthMonitor(self.health_config) for _ in replicas]
        self.retry = retry or RetryPolicy()
        self.degradation = degradation
        if stall_patience <= 0:
            raise ValueError(
                f"stall_patience must be positive, got {stall_patience}")
        self.stall_patience = stall_patience
        if fault_plan is not None:
            for rep in replicas:
                inj = fault_plan.injector_for(rep.name)
                rep.scheduler.fault_injector = inj
                rep.scheduler.engine.fault_injector = inj
        # request registry: every handle submit() ever returned maps to
        # a record; _live tracks where each unresolved record currently
        # lives (rewritten on every failover re-route)
        self._requests: Dict[Tuple[int, int], _GatewayRequest] = {}
        self._live: Dict[Tuple[int, int], _GatewayRequest] = {}
        self._retry_queue: List[Tuple[int, _GatewayRequest]] = []
        self._gstep = 0                    # gateway step counter
        self._quarantined_at: List[Optional[int]] = [None] * len(replicas)
        self.failovers = 0
        self.shed_requests = 0
        self.capped_requests = 0
        # degradation state
        self.degraded = False
        self.degraded_transitions = 0
        self._breach_run = 0
        self._ok_run = 0
        self._saved_budgets: Dict[int, Optional[int]] = {}

    @classmethod
    def from_engines(cls, engines: List[ServingEngine], *,
                     affinity_slack: int = 2, tracing: bool = False,
                     trace_buffer_events: Optional[int] = None,
                     slo_config=None, health=None, retry=None,
                     degradation=None, fault_plan=None,
                     stall_patience: int = 64,
                     **sched_kw) -> "ReplicaGateway":
        """``tracing=True`` gives every replica an enabled
        :class:`~repro_torch.serving.tracing.Tracer` (ring depth
        ``trace_buffer_events``) on the shared process clock, so
        :meth:`trace_events` can interleave the fleet's buffers into one
        timeline.  ``slo_config`` (an
        :class:`~repro_torch.serving.slo.SLOConfig`) arms every replica's
        tracer with its own :class:`~repro_torch.serving.slo.SLOMonitor` —
        breach state is per replica, the policies are shared.
        ``health`` / ``retry`` / ``degradation`` / ``fault_plan``
        configure the failure-handling layer (see the module docs)."""
        def sched(i, e):
            kw = dict(sched_kw)
            if "tracer" not in kw:
                tkw = {"enabled": tracing, "name": f"replica{i}"}
                if trace_buffer_events is not None:
                    tkw["buffer_events"] = trace_buffer_events
                if slo_config is not None:
                    from repro_torch.serving.slo import SLOMonitor
                    tkw["slo"] = SLOMonitor(slo_config)
                kw["tracer"] = Tracer(**tkw)
            return Scheduler(e, **kw)

        return cls([CapsuleReplica(f"replica{i}", sched(i, e))
                    for i, e in enumerate(engines)],
                   affinity_slack=affinity_slack, health=health,
                   retry=retry, degradation=degradation,
                   fault_plan=fault_plan, stall_patience=stall_patience)

    # -- routing -------------------------------------------------------------

    def _routable(self) -> List[int]:
        return [i for i in range(len(self.replicas))
                if self.health[i].routable]

    def _least_loaded(self, candidates: List[int]) -> int:
        return min(candidates,
                   key=lambda i: (self.replicas[i].load, i))

    def _route(self, request: Request) -> Tuple[int, str, int]:
        """Prefix affinity first, hash ownership second, load third —
        over *routable* replicas only.  Returns ``(replica index,
        reason, prefix match length)`` so the decision is traceable,
        not just its outcome."""
        alive = self._routable()
        if not alive:
            raise Overloaded(
                "no routable replica: every replica is quarantined or "
                "dead")
        floor = min(self.replicas[i].load for i in alive)
        matches = {i: self.replicas[i].scheduler.prefix_match_len(
            request.prompt) for i in alive}
        best = max(matches.values())
        if best > 0:
            idx = min((i for i in alive if matches[i] == best),
                      key=lambda i: (self.replicas[i].load, i))
            # a warm cache is not worth unbounded queueing: same slack
            # rule as hash ownership
            if self.replicas[idx].load <= floor + self.affinity_slack:
                return idx, "prefix_affinity", best
        caching = [i for i in alive
                   if self.replicas[i].scheduler.prefix_cache is not None]
        if caching and len(request.prompt) > 0:
            # stable owner for a not-yet-cached prefix: hash the first
            # KV block's worth of token ids
            kv = self.replicas[caching[0]].scheduler.engine.kv
            head = np.asarray(request.prompt[:kv.block_size], np.int32)
            owner = caching[zlib.crc32(head.tobytes()) % len(caching)]
            if self.replicas[owner].load <= floor + self.affinity_slack:
                return owner, "hash_owner", best
        return self._least_loaded(alive), "least_loaded", best

    def _fleet_queue_depth(self) -> int:
        return sum(len(r.scheduler.queue) for r in self.replicas)

    def _breached_tenants(self) -> set:
        out = set()
        for rep in self.replicas:
            mon = rep.scheduler.tracer.slo
            if mon is not None:
                out.update(b["tenant"] for b in mon.active_breaches())
        return out

    def submit(self, request: Request) -> Tuple[int, int]:
        """Route with prefix affinity / least load; returns a
        (replica, rid) handle usable with :meth:`result`.  Raises
        :class:`Overloaded` when no replica is routable or the
        degradation ladder is shedding."""
        if self.draining:
            raise RuntimeError("gateway is draining; admission closed")
        pol = self.degradation
        if self.degraded and pol is not None:
            if (pol.shed_queue_depth is not None
                    and self._fleet_queue_depth() >= pol.shed_queue_depth):
                self.shed_requests += 1
                self.replicas[0].scheduler.tracer.shed(request.tenant)
                raise Overloaded(
                    f"degraded: fleet queue depth "
                    f"{self._fleet_queue_depth()} at/over shed threshold "
                    f"{pol.shed_queue_depth}")
            if (pol.max_new_cap is not None
                    and request.tenant in self._breached_tenants()
                    and request.params.max_new_tokens > pol.max_new_cap):
                # over-budget tenant: serve a shorter answer rather
                # than shed — the cap is traced per request below
                orig = request.params.max_new_tokens
                request = Request(request.prompt,
                                  replace(request.params,
                                          max_new_tokens=pol.max_new_cap),
                                  encoder_input=request.encoder_input,
                                  tenant=request.tenant)
                self.capped_requests += 1
                idx, reason, match_len = self._route(request)
                rid = self._do_submit(idx, request, reason, match_len)
                self.replicas[idx].scheduler.tracer.overload_cap(
                    rid, request.tenant, orig, pol.max_new_cap)
                return idx, rid
        idx, reason, match_len = self._route(request)
        rid = self._do_submit(idx, request, reason, match_len)
        return idx, rid

    def _do_submit(self, idx: int, request: Request, reason: str,
                   match_len: int) -> int:
        rep = self.replicas[idx]
        rep.routed += 1
        rid = rep.scheduler.submit(request)
        rep.scheduler.tracer.route(rid, rep.name, reason, match_len,
                                   rep.load)
        rec = _GatewayRequest(handle=(idx, rid), request=request,
                              current=(idx, rid))
        self._requests[(idx, rid)] = rec
        self._live[(idx, rid)] = rec
        return rid

    # -- progress + health ---------------------------------------------------

    @staticmethod
    def _progress_sig(sched: Scheduler) -> tuple:
        """Everything a genuine unit of scheduler work changes at least
        one of.  An injected (or real) wedge that returns True from
        step() without doing anything leaves this identical — the
        signal the health monitor runs on."""
        eng = sched.engine
        m = sched.metrics
        return (eng.decode_steps, eng.prefill_tokens_executed,
                m.requests_completed, sched.preemptions,
                len(sched.queue), len(sched.active),
                len(sched.prefilling), len(sched.done), sched._next_rid)

    def step(self) -> bool:
        """One decode round on every routable replica with work, plus
        health bookkeeping, quarantine auto-rejoin, pending retries,
        and the degradation-ladder update.  Returns True when anything
        observable happened.  A ``serve.gateway_step`` span
        (``core/spans.py``), whose self time is that bookkeeping."""
        drive = False
        for rep in self.replicas:
            if getattr(rep.scheduler, "records_spans", False):
                drive = True
                break
        with SPANS.span("serve.gateway_step", step=self._gstep + 1,
                        drive=drive):
            return self._step_replicas()

    def _step_replicas(self) -> bool:
        self._gstep += 1
        progressed = False
        for i, rep in enumerate(self.replicas):
            mon = self.health[i]
            if mon.state == QUARANTINED:
                qat = self._quarantined_at[i]
                if (self.health_config.auto_rejoin and qat is not None
                        and self._gstep - qat
                        >= self.health_config.rejoin_cooldown_steps):
                    self.rejoin(i)
                    progressed = True
                continue
            if mon.state == DEAD:
                continue
            sched = rep.scheduler
            if not sched.has_work:
                continue
            sig0 = self._progress_sig(sched)
            try:
                sched.step()
            except Exception as e:   # noqa: BLE001 — replica failure
                tr = mon.record_failure(repr(e),
                                        fatal=isinstance(e, ReplicaCrashed))
                self._note_transition(i, tr)
                progressed = True    # the failure was handled — that
                continue             # counts against the watchdog
            made = self._progress_sig(sched) != sig0
            tr = mon.record_step(made)
            self._note_transition(i, tr)
            progressed = made or progressed
        progressed = self._pump_retries() or progressed
        self._update_degradation()
        return progressed

    def _note_transition(self, i: int,
                         tr: Optional[Dict[str, object]]) -> None:
        if tr is None:
            return
        rep = self.replicas[i]
        rep.scheduler.tracer.replica_health(
            rep.name, str(tr["from"]), str(tr["to"]), str(tr["reason"]),
            int(tr["consecutive_bad"]))  # type: ignore[call-overload]
        if tr["to"] == QUARANTINED:
            self._quarantined_at[i] = self._gstep
        if tr["to"] in (QUARANTINED, DEAD):
            self._salvage(i, str(tr["reason"]))

    # -- failover ------------------------------------------------------------

    def _salvage(self, i: int, reason: str) -> None:
        """Replica ``i`` left the routable set: harvest any finished
        outputs its scheduler still holds, abort the rest (slots, pins,
        blocks freed best-effort), and queue every orphaned request for
        a backed-off retry on the survivors."""
        rep = self.replicas[i]
        sched = rep.scheduler
        # finished outputs survive on the gateway record even after the
        # scheduler object is replaced at rejoin
        for (idx, rid), rec in list(self._live.items()):
            if idx == i and rid in sched.done:
                rec.output = sched.output(rid)
                del self._live[(idx, rid)]
        n_inflight = len(sched.active) + len(sched.prefilling)
        n_queued = len(sched.queue)
        states = sched.abort()
        for st in states:
            rec = self._live.pop((i, st.rid), None)
            if rec is None:
                continue       # submitted directly to the scheduler,
            rec.emitted = list(st.emitted)   # not through this gateway
            self._schedule_retry(rec, reason)
        self.failovers += 1
        sched.tracer.failover(rep.name, n_inflight, n_queued, reason)

    def _schedule_retry(self, rec: _GatewayRequest, error: str) -> None:
        rec.attempts += 1
        rec.last_error = error
        if rec.attempts > self.retry.max_retries:
            self._fail(rec, "retry_budget_exhausted")
            return
        ready = self._gstep + self.retry.backoff_steps(rec.attempts)
        self._retry_queue.append((ready, rec))

    def _fail(self, rec: _GatewayRequest, reason: str) -> None:
        idx, rid = rec.current
        rec.failed = RequestFailed(handle=rec.handle, rid=rid,
                                   reason=reason, attempts=rec.attempts,
                                   last_error=rec.last_error)
        self._live.pop(rec.current, None)
        self.replicas[idx].scheduler.tracer.request_failed(
            rid, reason, rec.attempts)

    def _pump_retries(self) -> bool:
        """Re-route every backed-off request whose wait expired.  With
        no routable replica: wait if a quarantined one may still rejoin,
        otherwise fail typed — never spin forever."""
        if not self._retry_queue:
            return False
        due = [(r, rec) for r, rec in self._retry_queue
               if r <= self._gstep]
        if not due:
            return False
        rest = [(r, rec) for r, rec in self._retry_queue
                if r > self._gstep]
        rejoin_possible = (
            self.health_config.auto_rejoin
            and any(m.state == QUARANTINED for m in self.health))
        progressed = False
        for ready, rec in due:
            alive = self._routable()
            if not alive:
                if rejoin_possible:
                    rest.append((ready, rec))   # a rejoin is coming
                    continue
                self._fail(rec, "no_routable_replica")
                progressed = True
                continue
            idx, reason, match_len = self._route(rec.request)
            rep = self.replicas[idx]
            prev_idx = rec.current[0]
            rep.routed += 1
            rid = rep.scheduler.submit(
                rec.request, resume_emitted=rec.emitted or None,
                retry=True, admit_while_draining=True)
            rep.scheduler.tracer.route(rid, rep.name, reason, match_len,
                                       rep.load)
            rep.scheduler.tracer.retry(
                rid, rec.attempts,
                self.retry.backoff_steps(rec.attempts),
                prev_replica=self.replicas[prev_idx].name)
            rec.current = (idx, rid)
            self._live[(idx, rid)] = rec
            progressed = True
        self._retry_queue = rest
        return progressed

    def rejoin(self, i: int) -> None:
        """Relaunch replica ``i``'s capsule.  In-process: a fresh
        scheduler over the *same* engine (the engine-held prefix cache
        survives, so re-routed prompts probe warm), rid numbering
        carried forward so the shared tracer/metrics never see a rid
        collision.  A fabric replica (anything exposing ``respawn``)
        instead cancels its old worker job and submits a fresh one for
        the same spec — the cross-process capsule relaunch."""
        rep = self.replicas[i]
        old = rep.scheduler
        mon = self.health[i]
        try:
            old.abort()        # should be empty post-salvage; make sure
        except Exception:      # noqa: BLE001 — best-effort, like salvage
            pass
        if hasattr(old, "respawn"):
            new = old.respawn(draining=self.draining)
        else:
            # the injector is carried, NOT reset: an exhausted transient
            # fault stays exhausted — the plan's schedule is absolute
            # over the replica's lifetime, so a rejoined replica does
            # not replay the stall that quarantined it
            inj = old.fault_injector
            new = Scheduler(
                old.engine, tracer=old.tracer,
                max_admissions_per_step=old.max_admissions_per_step,
                prefill_token_budget=old.prefill_token_budget,
                profile=old.profiler is not None,
                fault_injector=inj)
            new._next_rid = old._next_rid
            new.done.update(old.done)  # finished outputs stay reachable
            new.draining = self.draining
        rep.scheduler = new
        self._quarantined_at[i] = None
        tr = mon.mark_rejoined()
        rep.scheduler.tracer.replica_health(
            rep.name, str(tr["from"]), str(tr["to"]), str(tr["reason"]),
            int(tr["consecutive_bad"]))  # type: ignore[call-overload]
        kv = new.engine.kv
        pool = getattr(kv, "prefix_pool", None)
        warm = pool.in_use if pool is not None else 0
        rep.scheduler.tracer.rejoin(rep.name, mon.rejoins, warm)

    # -- degradation ladder --------------------------------------------------

    def _update_degradation(self) -> None:
        pol = self.degradation
        if pol is None:
            return
        qd = self._fleet_queue_depth()
        exhausted = ((pol.shed_queue_depth is not None
                      and qd >= pol.shed_queue_depth)
                     or not self._routable())
        breached = bool(self._breached_tenants())
        if breached:
            self._breach_run += 1
        else:
            self._breach_run = 0
        if exhausted or breached:
            self._ok_run = 0
        else:
            self._ok_run += 1
        if not self.degraded and (exhausted
                                  or self._breach_run >= pol.breach_steps):
            self._enter_degraded(
                "queue_exhausted" if exhausted else "slo_breach_sustained",
                qd)
        elif (self.degraded and not exhausted and not breached
                and self._ok_run >= pol.recover_steps):
            self._exit_degraded(qd)

    def _enter_degraded(self, reason: str, queue_depth: int) -> None:
        self.degraded = True
        self.degraded_transitions += 1
        pol = self.degradation
        assert pol is not None
        for i, rep in enumerate(self.replicas):
            b = rep.scheduler.prefill_token_budget
            self._saved_budgets[i] = b
            if b is not None:
                rep.scheduler.prefill_token_budget = max(
                    1, int(b * pol.budget_shrink))
        self.replicas[0].scheduler.tracer.overload(
            True, reason, queue_depth)

    def _exit_degraded(self, queue_depth: int) -> None:
        self.degraded = False
        for i, rep in enumerate(self.replicas):
            if i in self._saved_budgets:
                rep.scheduler.prefill_token_budget = self._saved_budgets[i]
        self._saved_budgets.clear()
        self.replicas[0].scheduler.tracer.overload(
            False, "recovered", queue_depth)

    # -- run / drain ---------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return (any(self.health[i].routable and r.scheduler.has_work
                    for i, r in enumerate(self.replicas))
                or bool(self._retry_queue)
                or (self.health_config.auto_rejoin
                    and any(m.state == QUARANTINED for m in self.health)
                    and any(r.scheduler.has_work for r in self.replicas)))

    def run(self) -> None:
        """Run until no routable replica has work and no retry is
        pending.  A fleet that makes zero observable progress for
        ``stall_patience`` consecutive steps raises instead of spinning
        — the drain-hang fix: quarantine normally resolves a wedged
        replica well before the watchdog trips, so hitting it means
        health thresholds are misconfigured or every replica is wedged
        below detection."""
        stagnant = 0
        while self.has_work:
            if self.step():
                stagnant = 0
                continue
            stagnant += 1
            if stagnant >= self.stall_patience:
                wedged = [self.replicas[i].name
                          for i, m in enumerate(self.health)
                          if m.routable
                          and self.replicas[i].scheduler.has_work]
                raise RuntimeError(
                    f"gateway made no progress for {stagnant} consecutive "
                    f"steps with work pending (replicas with stuck work: "
                    f"{wedged or 'none — retries cannot route'}); a "
                    f"wedged replica should have been quarantined — "
                    f"check HealthConfig thresholds vs stall_patience")

    def drain(self) -> None:
        """Graceful drain: no new admissions; every in-flight request
        either completes (possibly on another replica after failover)
        or resolves to a typed :class:`RequestFailed`."""
        self.draining = True
        for rep in self.replicas:
            rep.scheduler.draining = True
        self.run()
        # every record must resolve: harvest stragglers, fail the rest
        # loudly (a lost request must never be a silent hang for its
        # caller)
        for rec in self._requests.values():
            if rec.output is not None or rec.failed is not None:
                continue
            idx, rid = rec.current
            sched = self.replicas[idx].scheduler
            if rid in sched.done:
                rec.output = sched.output(rid)
                self._live.pop(rec.current, None)
            else:
                self._fail(rec, "lost_at_drain")

    # -- results / telemetry -------------------------------------------------

    def result(self, handle: Tuple[int, int]):
        """Resolve a handle from :meth:`submit`: the output tokens
        (np.ndarray) or a typed :class:`RequestFailed`.  Raises KeyError
        for a handle this gateway never issued and RuntimeError for a
        request that has not finished yet."""
        try:
            key = (int(handle[0]), int(handle[1]))
        except (TypeError, ValueError, IndexError):
            raise KeyError(f"malformed request handle {handle!r}: "
                           f"expected a (replica, rid) pair") from None
        rec = self._requests.get(key)
        if rec is None:
            raise KeyError(
                f"unknown request handle {key!r}: not issued by this "
                f"gateway's submit()")
        if rec.failed is not None:
            return rec.failed
        if rec.output is None:
            idx, rid = rec.current
            sched = self.replicas[idx].scheduler
            if rid not in sched.done:
                raise RuntimeError(
                    f"request {key!r} has not finished (now rid {rid} on "
                    f"{self.replicas[idx].name}, attempt "
                    f"{rec.attempts + 1}); step or drain the gateway")
            rec.output = sched.output(rid)
            self._live.pop(rec.current, None)
        return rec.output

    def stats(self) -> Dict[str, Any]:
        summaries = [rep.scheduler.metrics.summary() for rep in self.replicas]
        per = {}
        for rep, s in zip(self.replicas, summaries):
            entry = {**s, "routed": rep.routed, "capsule": rep.capsule}
            if rep.scheduler.tracer.slo is not None:
                entry["slo"] = rep.scheduler.tracer.slo.summary()
            if rep.scheduler.profiler is not None:
                entry["profile"] = rep.scheduler.profiler.summary()
            per[rep.name] = entry
        totals = merge_summaries(summaries)
        breaches = sum(p["slo"]["breaches"] for p in per.values()
                       if "slo" in p)
        if any("slo" in p for p in per.values()):
            totals["slo_breaches"] = breaches
        fleet = {
            "health": {rep.name: mon.summary()
                       for rep, mon in zip(self.replicas, self.health)},
            "failovers": self.failovers,
            "requests_failed": sum(1 for r in self._requests.values()
                                   if r.failed is not None),
            "requests_retried": sum(1 for r in self._requests.values()
                                    if r.attempts > 0),
            "retries_pending": len(self._retry_queue),
            "shed_requests": self.shed_requests,
            "capped_requests": self.capped_requests,
            "degraded": self.degraded,
            "degraded_transitions": self.degraded_transitions,
        }
        return {"replicas": per, "totals": totals, "fleet": fleet}

    # -- tracing -------------------------------------------------------------

    @property
    def tracers(self) -> List[Tracer]:
        return [rep.scheduler.tracer for rep in self.replicas]

    def trace_events(self) -> List[Dict[str, Any]]:
        """The fleet's merged timeline: every replica's ring buffer
        interleaved on the shared clock, replica-stamped."""
        return merge_traces(self.tracers)

    def export_trace_jsonl(self, path):
        """Merged JSONL event log (one JSON object per line)."""
        return export_jsonl(self.trace_events(), path)

    def export_chrome_trace(self, path):
        """Chrome trace-event file: replicas as processes, request spans
        as async lanes — loads directly in Perfetto/chrome://tracing."""
        return export_chrome_trace(
            {rep.name: rep.scheduler.tracer.snapshot()
             for rep in self.replicas}, path)


def launch_capsule_replicas(
        n: int, engine_factory: Callable[[], ServingEngine], work_dir,
        image_definition=None) -> Tuple[ReplicaGateway, Any]:
    """Deploy one immutable image and launch ``n`` serving replicas from
    it, each engine constructed inside a ``CapsuleRuntime.run`` (the
    ``ch-run`` analogue) so the launch bookkeeping — image hash, uid map,
    scrubbed env — is recorded per replica.  Returns (gateway, deployment).
    The default image is the one the port runs in,
    ``deploy.pytorch_image("serving-replica")``; the engines land on the
    device ``engine_factory`` gives them (the card by the engine's own
    default).
    """
    from repro_torch.core import deploy as D

    if n <= 0:
        raise ValueError(f"need at least one replica, got n={n}")
    if not callable(engine_factory):
        raise TypeError(
            f"engine_factory must be callable, got "
            f"{type(engine_factory).__name__}")
    pipe = D.DeploymentPipeline()
    definition = image_definition or D.pytorch_image("serving-replica")
    dep = pipe.deploy(definition, Path(work_dir))
    replicas = []
    for r in range(n):
        res = dep.run(engine_factory, ranks=1)[0]
        replicas.append(CapsuleReplica(
            f"replica{r}", Scheduler(res.value),
            capsule={"image": res.image, "uid_map": res.uid_map,
                     "env": res.env, "wall_time_s": res.wall_time_s}))
    return ReplicaGateway(replicas), dep
