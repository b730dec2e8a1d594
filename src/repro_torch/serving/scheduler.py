"""Continuous-batching scheduler: admission queue + slot manager.

A copy of ``repro.serving.scheduler`` for the port; the host-side logic is
the reference's line for line.

Spans (``core/spans.py``'s recorder, which records while a
``torch.profiler`` session records or while a step drives it: its tracer
is enabled, or the scheduler was built with ``profile=True``): each step
is a ``serve.step`` span with the children ``serve.admit``,
``serve.prefill`` (the engine's ``serve.prefill.build`` / ``.feed`` /
``.replay`` per round, and ``serve.sample.first`` for the first tokens
with their read-back), ``serve.decode.build`` (the per-slot arrays), the
engine's ``serve.decode.feed`` and ``serve.decode.replay``,
``serve.sample`` (with its read-back) and ``serve.retire`` (token
bookkeeping, retirement, the step's close).  The device units of the step
(each round's copies, its replay, the logit clones, each sample call with
its read-back) carry CUDA events; the recorder settles them while the
card runs the step's decode round and after the step's read-back, waiting
for neither, and the card's idle time before each unit is put down to the
innermost span the host was in while the card waited (the recorder's gap
rule).  ``engine_step`` then carries the step's device busy and idle
seconds and the idle by span, and ``profile=True`` feeds each phase's
device time and the step's idle into :attr:`profiler`.  Nothing
synchronises beyond the step's read-backs.

One scheduler drives one :class:`~repro_torch.serving.engine.ServingEngine`
(conceptually: the serving process inside one ``ch-run`` capsule).  The
loop is the standard continuous-batching shape:

    admit:   drain the queue into free slots in *batches*: as many
             queued prompts as slots, KV blocks, and the engine's
             ``prefill_batch`` allow claim slots and become *in-flight
             prefills* (``engine.begin_prefill``); each request's
             prefix-cache probe still runs first so only uncached
             suffixes will execute;
    prefill: run at most ``prefill_token_budget`` executed token
             positions of chunked prefill across the in-flight cursors
             (``engine.advance_prefill``) — SplitFuse-style
             interleaving: instead of draining every admission's chunk
             rounds before the next decode step, each scheduler step is
             a *token-budgeted round* of prefill fused with one decode
             step, so running sequences never stall for a whole
             admission wave.  Rows whose prompt completes sample their
             first tokens in one vectorized call and join decode the
             same step; unfinished rows stay parked on the engine,
             resumable mid-prompt next step.  ``None`` (the default)
             removes the cap — wave-at-once admission;
    decode:  one ``decode_once`` over the pooled cache advances *every*
             live sequence by one token, each sampled with its own
             ``SamplingParams`` (mid-prefill slots' rows are masked to
             the trash block by the engine);
    retire:  a sequence that hits its own ``max_new_tokens`` or emits
             its ``eos_token`` leaves immediately — its KV blocks
             return to the ring, its prefix-block pins are released,
             and the slot is refilled on the next admit, mid-decode of
             the others.

Partially-prefilled slots are first-class scheduler state
(``self.prefilling``): decode-time preemption may pick one as victim
(``engine.cancel_prefill`` — it wastes the least finished work), an
engine error during a prefill round re-queues every in-flight admission
with prefix pins released, gateway drain keeps stepping until in-flight
prefills finish, and a preempted mid-prefill request resumes later from
whatever the prefix cache holds at that point.

Prefix-cache interplay: the matched blocks are pinned (refcounted) for
the request's lifetime so LRU eviction can never reclaim KV a live
sequence was served from, and every admitted prompt is inserted back
into the radix tree right after its prefill, making its KV available to
the next request that shares it.  Co-admission respects this: a queued
request sharing at least one full KV block of prefix with a request
already collected into the current batch is deferred one round, so it
admits *after* the insert and HITs the shared prefix instead of
recomputing it in parallel — shared-prefix bursts serialize (each later
request then skips the shared compute), unrelated prompts batch.

With a paged engine the KV pool can be sized below worst case, so
``OutOfBlocks`` is a real event on both sides of the loop and neither
may lose a request:

    admission — the head request stays in the queue until its prefill
        blocks actually allocate; on ``OutOfBlocks`` its prefix pins are
        released, it returns to the *head*, and admission stops for the
        round (a retirement must free blocks first);
    decode    — when a live sequence cannot grow by one block, the most
        recently admitted *other* sequence is preempted (slot and blocks
        freed, prefix pins released, request re-queued at the head); a
        preempted request resumes later by re-prefilling its prompt plus
        the tokens it already emitted — recompute-style preemption, so
        no KV swap space is needed and greedy outputs are unchanged.

This replaces the seed engine's run-everything-to-the-global-max loop:
short requests stop costing decode work the step they finish, and
``decode_steps`` accounting makes the saving testable.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.spans import SPANS
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kvcache import OutOfBlocks
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.tracing import Tracer


@dataclass
class _ReqState:
    rid: int
    request: Request
    slot: int = -1
    pos: int = 0                       # next cache write position
    admit_seq: int = -1                # admission-recency (victim pick)
    emitted: List[int] = field(default_factory=list)
    finish_reason: str = ""
    cached_len: int = 0                # tokens served from the prefix cache
    prefix_blocks: List[int] = field(default_factory=list)   # pinned blocks
    inflight_seq: Optional[np.ndarray] = None   # sequence mid-prefill
    prefix_counted: bool = False       # one record_prefix per request
    admitted_before: bool = False      # re-admission => resumed span


class Scheduler:
    """Admission queue + continuous-batching slot manager for one engine."""

    def __init__(self, engine: ServingEngine,
                 metrics: Optional[ServingMetrics] = None,
                 clock=time.perf_counter,
                 max_admissions_per_step: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 profile: bool = False,
                 fault_injector=None):
        self.engine = engine
        self.max_slots = engine.max_slots
        # deterministic fault injection (tests/chaos harness): the
        # injector fires at the top of step() and inside the engine's
        # prefill/decode ops; None (the default) costs one attribute
        # check per step
        self.fault_injector = fault_injector
        engine.fault_injector = fault_injector
        # cap on requests admitted per scheduler step (None = drain all
        # that fit).  1 reproduces the old one-at-a-time admission — the
        # benchmark baseline — and smooths decode latency under bursts.
        self.max_admissions_per_step = max_admissions_per_step
        # SplitFuse knob: max *executed* prefill token positions per
        # step (None = unbudgeted wave-at-once).  Each step then fuses
        # at most this much chunked prefill with one decode round, so
        # decode latency jitter under admission bursts is bounded by
        # the budget, not by the whole wave.
        if prefill_token_budget is not None and prefill_token_budget <= 0:
            raise ValueError(
                f"prefill_token_budget must be positive or None, got "
                f"{prefill_token_budget}")
        self.prefill_token_budget = prefill_token_budget
        # one recording path: the tracer owns the metrics and feeds its
        # counters; a disabled tracer (the default) only forwards —
        # near-zero overhead over calling the metrics directly.  The
        # tracer is also bound onto the engine / KV ledger / prefix
        # cache so their events land in the same per-replica buffer.
        if tracer is None:
            tracer = Tracer(metrics or ServingMetrics(clock=clock),
                            clock=clock)
        self.tracer = tracer
        self.metrics = tracer.metrics
        engine.tracer = tracer
        engine.kv.tracer = tracer
        if engine.prefix_cache is not None:
            engine.prefix_cache.tracer = tracer
        # step-phase profiling: with profile=True every step drives the
        # span recorder, and each phase's device time (its units' time on
        # the device's clock) and the step's device idle feed
        # self.profiler's windows; nothing synchronises
        self.profiler = None
        if profile:
            from repro_torch.serving.profiling import StepProfiler
            self.profiler = StepProfiler()
        self.queue: deque = deque()
        self.active: Dict[int, _ReqState] = {}          # slot -> state
        self.prefilling: Dict[int, _ReqState] = {}      # slot -> mid-prefill
        self.done: Dict[int, _ReqState] = {}            # rid  -> state
        self.draining = False
        self.preemptions = 0               # decode-time OutOfBlocks defers
        self.admission_stalls = 0          # admit-time OutOfBlocks retries
        self._next_rid = 0
        self._admit_counter = 0            # monotonic admission stamp
        # eviction counting is per-scheduler; the cache outlives us
        pc = engine.prefix_cache
        self._evict_base = pc.stats.evicted_blocks if pc else 0

    @property
    def decode_steps(self) -> int:
        return self.metrics.decode_steps

    @property
    def prefix_cache(self):
        return self.engine.prefix_cache

    # -- submission ----------------------------------------------------------

    def submit(self, request: Request, *,
               resume_emitted: Optional[List[int]] = None,
               retry: bool = False,
               admit_while_draining: bool = False) -> int:
        """Queue a request.  The keyword knobs exist for gateway
        failover: ``resume_emitted`` seeds the request with tokens it
        already emitted on a failed replica (it re-prefills prompt +
        emitted[:-1] exactly like a recompute-preemption resume),
        ``retry=True`` records a retry instead of a second logical
        submit, and ``admit_while_draining`` lets a draining gateway
        re-home salvaged work past this scheduler's closed admission."""
        if self.draining and not admit_while_draining:
            raise RuntimeError("scheduler is draining; admission closed")
        if len(request.prompt) == 0:
            raise ValueError(
                "empty prompt: a request needs at least one token "
                "(the first sample comes from the prefill logits)")
        sp = request.params
        need = len(request.prompt) + sp.max_new_tokens
        if need > self.engine.max_seq_len:
            raise ValueError(
                f"prompt ({len(request.prompt)}) + max_new_tokens "
                f"({sp.max_new_tokens}) exceeds max_seq_len "
                f"({self.engine.max_seq_len})")
        kv = self.engine.kv
        if kv._blocks_for(need) > kv.pool.num_blocks:
            raise ValueError(
                f"request needs {kv._blocks_for(need)} KV blocks at full "
                f"length but the pool holds {kv.pool.num_blocks}; it could "
                "never be scheduled even alone")
        rid = self._next_rid
        self._next_rid += 1
        st = _ReqState(rid, request)
        if resume_emitted:
            # salvage resume: the emitted tokens ride the recompute-
            # preemption path — _collect_batch re-prefills prompt +
            # emitted[:-1] and the span reads resumed=True
            st.emitted = [int(t) for t in resume_emitted]
            st.admitted_before = True
        self.queue.append(st)
        self.tracer.submit(rid, request.tenant, retry=retry)
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active or self.prefilling)

    @property
    def load(self) -> int:
        return len(self.queue) + len(self.active) + len(self.prefilling)

    def prefix_match_len(self, prompt: np.ndarray) -> int:
        """Longest cached prefix this replica holds (gateway affinity)."""
        pc = self.prefix_cache
        return pc.peek(prompt) if pc is not None else 0

    # -- the loop ------------------------------------------------------------

    def _shares_block(self, a: np.ndarray, b: np.ndarray) -> bool:
        """True when two prompts share at least one full KV block of
        common prefix — i.e. co-admitting them would recompute KV the
        prefix cache could have shared."""
        n = min(len(a), len(b), self.engine.kv.block_size)
        return (n == self.engine.kv.block_size
                and bool(np.array_equal(a[:n], b[:n])))

    def _collect_batch(self, limit: int):
        """Pop as many admissible head-of-queue requests as slots, KV
        blocks, and ``limit`` allow.  Prefix pins are taken here; the
        caller must release them if the prefill never happens.  Returns
        ``(states, seqs, starts, blocks_lists)`` in queue order."""
        kv = self.engine.kv
        pc = self.prefix_cache
        states, seqs, starts, blocks_lists = [], [], [], []
        # in-flight prefills haven't inserted their prefix yet either:
        # a candidate sharing a block with one must defer the same way
        inflight_seqs = [st.inflight_seq for st in self.prefilling.values()
                         if st.inflight_seq is not None]
        blocks_needed = 0
        while (self.queue and len(states) < limit
               and len(states) < kv.free_slot_count):
            st = self.queue[0]
            req = st.request
            if req.params.max_new_tokens <= 0:      # nothing to generate
                self.queue.popleft()
                st.finish_reason = "length"
                self.done[st.rid] = st
                self.tracer.retire(st.rid, 0, "length")
                continue
            resumed = bool(st.emitted)              # preempted earlier
            # a resumed request re-prefills prompt + all emitted tokens
            # except the last, which is still waiting to be fed to decode
            seq = (req.prompt if not resumed else
                   np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(st.emitted[:-1], np.int32)]))
            if kv.pool.available < blocks_needed + kv._blocks_for(len(seq)):
                # KV pool dry for THIS request: stop collecting BEFORE
                # touching the prefix cache so a request parked at the
                # head doesn't re-count lookup stats (or churn pins)
                # once per retry; stall only if nothing at all fit
                if not states:
                    self.admission_stalls += 1
                    self.tracer.admission_stall(
                        "kv_pool_dry", len(self.queue), rid=st.rid)
                break
            if pc is not None and any(
                    self._shares_block(seq, s)
                    for s in seqs + inflight_seqs):
                # the candidate shares >= one KV block of prefix with a
                # request already in this batch: defer it one round so
                # it can HIT the prefix the earlier request is about to
                # insert instead of recomputing it in parallel —
                # shared-prefix bursts serialize, unrelated prompts batch
                break
            cached_len, blocks = (0, [])
            if pc is not None:
                cached_len, blocks = pc.lookup(seq)
            self.queue.popleft()
            st.cached_len, st.prefix_blocks = cached_len, blocks
            states.append(st)
            seqs.append(seq)
            starts.append(cached_len)
            blocks_lists.append(blocks)
            blocks_needed += kv._blocks_for(len(seq))
        return states, seqs, starts, blocks_lists

    def _admit(self) -> int:
        """Batched admission: claim slots + pins and register in-flight
        prefill cursors (no chunk rounds yet — those run under the
        budget in ``_advance_prefill``).  Returns how many requests were
        admitted (the step loop uses this to tell a capped-but-
        progressing round from a genuine admission deadlock)."""
        admitted = 0
        pc = self.prefix_cache
        while self.queue and self.engine.kv.free_slot_count > 0:
            limit = self.engine.prefill_batch
            if self.max_admissions_per_step is not None:
                limit = min(limit, self.max_admissions_per_step - admitted)
            if limit <= 0:
                return admitted
            states, seqs, starts, blocks_lists = self._collect_batch(limit)
            if not states:
                return admitted
            try:
                cursors = self.engine.begin_prefill(
                    seqs, [st.request.encoder_input for st in states],
                    start_pos=starts, prefix_blocks=blocks_lists)
            except Exception as e:
                # never lose a request or its pins: the engine released
                # every slot (all-or-nothing), so requeue the whole
                # batch at the head, in order.  OutOfBlocks (unreachable
                # given the pre-check) stalls; anything else — device
                # OOM, an engine assert — propagates with the scheduler
                # state intact, so the caller can retry or drain.
                for st, blocks in zip(reversed(states),
                                      reversed(blocks_lists)):
                    if pc is not None and blocks:
                        pc.release(blocks)
                    st.prefix_blocks = []
                    self.queue.appendleft(st)
                if not isinstance(e, OutOfBlocks):
                    raise
                self.admission_stalls += 1
                self.tracer.admission_stall(
                    "out_of_blocks", len(self.queue),
                    rid=states[0].rid if states else -1)
                return admitted
            admitted += len(states)
            for st, seq, cur in zip(states, seqs, cursors):
                st.slot = cur.slot
                st.admit_seq = self._admit_counter
                self._admit_counter += 1
                st.inflight_seq = seq
                st.pos = len(seq)          # cache position once prefill ends
                self.tracer.bind_slot(cur.slot, st.rid)
                if pc is not None:
                    # the probe event fires every admission (a resumed
                    # request's re-probe is part of its span), but the
                    # metrics count one prefix outcome per request, even
                    # across mid-prefill preemptions and re-admissions
                    self.tracer.prefix_probe(st.rid, st.cached_len,
                                             len(seq),
                                             count=not st.prefix_counted)
                    st.prefix_counted = True
                self.tracer.admit(st.rid, cur.slot, len(seq), st.cached_len,
                                  resumed=st.admitted_before)
                st.admitted_before = True
                self.prefilling[cur.slot] = st
        return admitted

    def _advance_prefill(self) -> int:
        """One budgeted round of chunked prefill across every in-flight
        admission.  Completed rows insert their prefix, sample their
        first token (fresh admissions) in one vectorized call, and join
        the decode set; unfinished rows stay in ``self.prefilling`` with
        their cursor parked on the engine.  Returns how many rows
        completed."""
        if not self.prefilling:
            return 0
        pc = self.prefix_cache
        real0 = self.engine.prefill_tokens
        exec0 = self.engine.prefill_tokens_executed
        try:
            completed = self.engine.advance_prefill(
                token_budget=self.prefill_token_budget)
        except Exception:
            # the engine released every in-flight slot (all-or-nothing
            # per advance call): requeue every mid-prefill request with
            # its pins released, oldest admission back at the head, then
            # let the error propagate with the scheduler state intact
            for st in sorted(self.prefilling.values(),
                             key=lambda s: -s.admit_seq):
                if pc is not None and st.prefix_blocks:
                    pc.release(st.prefix_blocks)
                self.tracer.unbind_slot(st.slot)
                st.prefix_blocks = []
                st.slot = -1
                st.cached_len = 0
                st.inflight_seq = None
                self.queue.appendleft(st)
            self.prefilling.clear()
            raise
        executed = self.engine.prefill_tokens_executed - exec0
        self.tracer.prefill_work(
            self.engine.prefill_tokens - real0, executed)
        if self.prefill_token_budget is not None:
            self.tracer.budget_round(executed, self.prefill_token_budget)
        fresh: List[_ReqState] = []
        fresh_logits: List[torch.Tensor] = []
        for cur in completed:
            st = self.prefilling.pop(cur.slot)
            seq, st.inflight_seq = st.inflight_seq, None
            if pc is not None:
                pc.insert(seq, st.slot)
                self.metrics.prefix_evictions = (pc.stats.evicted_blocks
                                                 - self._evict_base)
            if st.emitted:                      # resumed: last token pending
                self.active[st.slot] = st
            else:
                fresh.append(st)
                # stays device-resident: the only host sync of the round
                # is sample_tokens reading back the sampled token ids
                fresh_logits.append(cur.last_logits)
        if fresh:
            # every first token of the round in one vectorized sample
            with SPANS.span("serve.sample.first", device=self.engine.device):
                toks = self.engine.sample_tokens(
                    torch.stack(fresh_logits),
                    np.asarray([st.request.params.temperature
                                for st in fresh], np.float32),
                    np.asarray([st.request.params.greedy for st in fresh]))
            for st, tok in zip(fresh, toks):
                tok = int(tok)
                st.emitted.append(tok)
                self.tracer.first_token(st.rid)
                if not self._maybe_retire(st, tok):
                    self.active[st.slot] = st
        return len(completed)

    def _preempt(self, st: _ReqState) -> None:
        """Defer a live or mid-prefill request: free its slot and KV
        blocks (cancelling the in-flight cursor if its prefill never
        finished), release its prefix pins, and put it back at the head
        of the queue.  It will resume by re-prefilling prompt + emitted
        tokens (recompute-style preemption) once blocks are available
        again, probing the prefix cache afresh — partial prefill work
        survives only through whatever prefixes are cached."""
        mid_prefill = st.slot in self.prefilling
        if mid_prefill:
            self.prefilling.pop(st.slot)
            self.engine.cancel_prefill(st.slot)
            st.inflight_seq = None
        else:
            self.active.pop(st.slot, None)
            self.engine.free_slot(st.slot)
        if st.prefix_blocks:
            self.prefix_cache.release(st.prefix_blocks)
            st.prefix_blocks = []
        self.tracer.preempt(st.rid, mid_prefill)
        self.tracer.unbind_slot(st.slot)
        st.slot = -1
        st.cached_len = 0
        self.queue.appendleft(st)
        self.preemptions += 1

    def _pick_victim(self, exclude_slot: int) -> Optional[_ReqState]:
        """Most recently *admitted* live or mid-prefill request other
        than the one trying to grow — freeing the youngest admission
        wastes the least finished work, and a mid-prefill slot (always
        among the youngest) wastes none of its decode progress.
        (Admission recency, not rid: a resumed old request is younger
        than a long-running new one.)"""
        candidates = [st for slot, st in self.active.items()
                      if slot != exclude_slot]
        candidates += [st for slot, st in self.prefilling.items()
                       if slot != exclude_slot]
        return (max(candidates, key=lambda st: st.admit_seq)
                if candidates else None)

    def _maybe_retire(self, st: _ReqState, tok: int) -> bool:
        sp = st.request.params
        reason = ""
        if len(st.emitted) >= sp.max_new_tokens:
            reason = "length"
        elif sp.eos_token is not None and tok == sp.eos_token:
            reason = "eos"
        if not reason:
            return False
        st.finish_reason = reason
        self.active.pop(st.slot, None)
        self.engine.free_slot(st.slot)
        if st.prefix_blocks:
            self.prefix_cache.release(st.prefix_blocks)
            st.prefix_blocks = []
        self.done[st.rid] = st
        self.tracer.retire(st.rid, len(st.emitted), reason)
        self.tracer.unbind_slot(st.slot)
        return True

    def _grow_or_preempt(self) -> None:
        """Back every live sequence's next token position with a block.
        When the pool is dry, preempt the youngest other request and
        retry; a sequence with nobody left to evict defers itself (it
        can always fit alone later — submit() guarantees that)."""
        for slot in sorted(self.active):
            st = self.active.get(slot)
            if st is None:                 # preempted earlier this pass
                continue
            while True:
                try:
                    self.engine.kv.ensure_capacity(slot, st.pos + 1)
                    break
                except OutOfBlocks:
                    victim = self._pick_victim(exclude_slot=slot)
                    self._preempt(victim if victim is not None else st)
                    if victim is None:
                        break              # st itself deferred; move on

    @property
    def records_spans(self) -> bool:
        """Whether this scheduler's steps drive the span recorder: its
        tracer is enabled or it profiles its steps."""
        return self.tracer.enabled or self.profiler is not None

    def _close_step(self, tr, decoded: bool, admitted: int, completed: int,
                    executed: int, t0: float, t1: float, t2: float,
                    t3: float, dev=None) -> None:
        """Emit the per-step engine-timeline event (phase breakdown on
        the host's clock + gauges snapshot, and the device units the
        recorder settled in the step: ``dev``, what it settled while the
        card ran the decode round, and the rest after the read-back) and
        sample the step gauges into the metrics when a decode round
        actually ran (the pre-tracing semantics)."""
        kv = self.engine.kv
        t4 = tr.clock()
        dev = SPANS.settle(into=dev)
        tr.engine_step(
            decoded=decoded, queue_depth=len(self.queue),
            active=len(self.active), max_slots=self.max_slots,
            admitted=admitted, completed=completed,
            prefill_executed=executed, budget=self.prefill_token_budget,
            dur_admit_s=t1 - t0, dur_prefill_s=t2 - t1,
            dur_decode_s=t3 - t2, dur_sample_s=t4 - t3,
            free_blocks=kv.pool.available, free_slots=kv.free_slot_count,
            inflight=len(self.prefilling),
            prefix_pins=(kv.prefix_pool.in_use
                         if kv.prefix_pool is not None else 0),
            device=dev)
        if self.profiler is not None and dev is not None:
            # a unit's phase: the second part of the span it started in
            # (serve.prefill.replay -> prefill, serve.sample.first -> sample)
            phase = dict.fromkeys(("admit", "prefill", "decode", "sample"),
                                  0.0)
            for _, span, a, b in dev["units"]:
                parts = span.split(".")
                if len(parts) > 1 and parts[1] in phase:
                    phase[parts[1]] += b - a
            self.profiler.record_step(
                phase["admit"], phase["prefill"], phase["decode"],
                phase["sample"], dev["idle_s"])
        tr.check_slo()

    def step(self) -> bool:
        """One token-budgeted round: admit into free slots, run at most
        ``prefill_token_budget`` executed tokens of chunked prefill
        across in-flight admissions, then decode one token for every
        live sequence.  Returns False when there was nothing to do.

        Every call emits one ``engine_step`` trace event with the phase
        durations on the host's clock (admission / prefill-advance /
        decode dispatch / sample+retire), a gauges snapshot and, while
        the span recorder records, the device units it settled, so a
        stalled request can be read against what the engine was actually
        doing that step."""
        fi = self.fault_injector
        if fi is not None and fi.on_step() == "stall":
            # injected wedge: claim liveness, do nothing.  This is the
            # capsule that hangs without exiting — return-value-based
            # progress checks are satisfied, only the gateway's
            # progress-signature watchdog can tell
            return True
        tr = self.tracer
        with SPANS.span("serve.step", step=tr.current_step,
                        drive=self.records_spans):
            return self._run_step(tr)

    def _run_step(self, tr) -> bool:
        t0 = tr.clock()
        with SPANS.span("serve.admit"):
            admitted = self._admit()
        t1 = tr.clock()
        exec0 = self.engine.prefill_tokens_executed
        with SPANS.span("serve.prefill"):
            completed = self._advance_prefill()
        executed = self.engine.prefill_tokens_executed - exec0
        t2 = tr.clock()
        if not self.active:
            if self.prefilling:
                ret = True                 # prefill progressing; no decode yet
            elif self.queue and not admitted and not completed:
                # nothing live, nothing in flight, nothing admitted:
                # with the pool idle this is unservable demand, not a
                # transient — fail loudly instead of spinning forever
                raise RuntimeError(
                    "admission deadlock: queue non-empty, no active "
                    "sequences, and prefill still cannot get blocks")
            else:
                # everything admitted this step retired at its first
                # token (or the admission cap paused the queue)
                ret = bool(self.queue) or admitted > 0 or completed > 0
            self._close_step(tr, False, admitted, completed, executed,
                             t0, t1, t2, t2)
            return ret
        with SPANS.span("serve.decode.build"):
            self._grow_or_preempt()
            if not self.active:            # everything deferred; retry
                self._close_step(tr, False, admitted, completed, executed,
                                 t0, t1, t2, t2)
                return bool(self.queue or self.prefilling)
            S = self.max_slots
            tokens = np.zeros(S, np.int32)
            positions = np.zeros(S, np.int32)
            temps = np.ones(S, np.float32)
            greedy = np.zeros(S, bool)
            for slot, st in self.active.items():
                tokens[slot] = st.emitted[-1]
                positions[slot] = st.pos
                temps[slot] = st.request.params.temperature
                greedy[slot] = st.request.params.greedy
        logits = self.engine.decode_once(tokens, positions)
        t3 = tr.clock()
        # the card runs the decode round: settle what has finished (the
        # idle split's host work then costs the card nothing)
        dev = SPANS.settle()
        with SPANS.span("serve.sample", device=self.engine.device):
            toks = self.engine.sample_tokens(logits, temps, greedy)
        with SPANS.span("serve.retire"):
            # per-tenant inter-token gaps: record before retirement pops
            # the rows' last-token timestamps
            tr.decode_tokens([st.rid for st in self.active.values()])
            for slot in list(self.active):
                st = self.active[slot]
                st.pos += 1
                tok = int(toks[slot])
                st.emitted.append(tok)
                if tr.enabled:
                    tr.decode(st.rid, st.pos - 1, tok)
                self._maybe_retire(st, tok)
            self._close_step(tr, True, admitted, completed, executed,
                             t0, t1, t2, t3, dev)
        return True

    def run(self) -> None:
        """Run until the queue and all slots are empty."""
        while self.has_work:
            self.step()

    def drain(self) -> None:
        """Graceful drain: close admission, finish all in-flight work."""
        self.draining = True
        self.run()

    def abort(self) -> List[_ReqState]:
        """Failover salvage: cancel every in-flight cursor, free every
        live slot, release every prefix pin, close admission, and return
        the orphaned request states — in-flight first (oldest admission
        first), then queue order — so a gateway can re-route them with
        their emitted-so-far tokens (the recompute-preemption resume).

        Engine-side frees are best-effort: a crashed capsule's pool dies
        with the process anyway, but the request-side bookkeeping (the
        states, their emitted tokens) must survive regardless."""
        pc = self.prefix_cache
        inflight = sorted(list(self.prefilling.values())
                          + list(self.active.values()),
                          key=lambda s: s.admit_seq)
        mid_prefill_slots = set(self.prefilling)
        salvaged: List[_ReqState] = []
        for st in inflight:
            try:
                if st.slot in mid_prefill_slots:
                    self.engine.cancel_prefill(st.slot)
                else:
                    self.engine.free_slot(st.slot)
            except Exception:   # noqa: BLE001 — dead capsule: its pool
                pass            # died with it; nothing left to free
            if pc is not None and st.prefix_blocks:
                try:
                    pc.release(st.prefix_blocks)
                except Exception:   # noqa: BLE001 — same: best-effort
                    pass
            st.prefix_blocks = []
            self.tracer.unbind_slot(st.slot)
            st.slot = -1
            st.cached_len = 0
            st.inflight_seq = None
            salvaged.append(st)
        self.prefilling.clear()
        self.active.clear()
        salvaged.extend(self.queue)
        self.queue.clear()
        self.draining = True
        return salvaged

    # -- results -------------------------------------------------------------

    def output(self, rid: int) -> np.ndarray:
        return np.asarray(self.done[rid].emitted, np.int32)

    def finish_reason(self, rid: int) -> str:
        return self.done[rid].finish_reason
