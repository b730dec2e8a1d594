"""Serving telemetry: TTFT, throughput, queue depth, slot occupancy.

Collected by the scheduler on every admission/decode/retire and exported
as JSON for the benchmark harness (``BENCH_serving.json``).  Latency
percentiles are computed over completed requests; gauge series (queue
depth, slot occupancy) are sampled once per scheduler step.  The clock is
injectable so tests can drive deterministic timings.

Memory is bounded for month-long deployments (the source paper's
deploy-and-run setting): per-request timing entries are kept for every
*in-flight* request plus the most recent ``sample_cap`` finished ones
(older finished entries are evicted FIFO), and every percentile series
lives in a :class:`~repro_torch.serving.slo.SlidingWindow` ring.  Totals —
request counts, token counts, finish reasons, gauge means/peaks — are
running scalars and stay exact forever.  Below the cap nothing is ever
evicted, so small runs (every test, every benchmark) see byte-identical
numbers to the unbounded implementation.

Per-tenant rollups: each request carries a tenant label (threaded from
``Request.tenant`` through ``Tracer.submit``); TTFT, inter-token gap and
queue-wait land in that tenant's :class:`~repro_torch.serving.slo.TenantStats`
windows, surfaced under ``summary()["tenants"]`` and merged across
replicas by :func:`merge_summaries`.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from repro_torch.serving.slo import (SlidingWindow, TenantStats,
                                     merge_tenant_summaries)

DEFAULT_SAMPLE_CAP = 4096


def _pct(xs: List[float], q: float) -> float:
    """Percentile by linear interpolation (numpy-free on purpose: callable
    from inside a capsule without pulling the model stack)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    f = (len(s) - 1) * q
    lo, hi = int(f), min(int(f) + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (f - lo)


def atomic_write_json(path, obj: dict) -> Path:
    """Write JSON via a same-directory temp file + ``os.replace`` so a
    capsule killed mid-write leaves the previous snapshot readable, never
    a truncated file (``--metrics-interval-steps`` relies on this)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, sort_keys=True,
                              default=str) + "\n")
    os.replace(tmp, path)
    return path


class ServingMetrics:
    """Per-request timings + per-step gauges for one scheduler."""

    def __init__(self, clock=time.perf_counter,
                 sample_cap: int = DEFAULT_SAMPLE_CAP,
                 tenant_window: int = 512):
        if sample_cap <= 0:
            raise ValueError(f"sample_cap must be positive, got {sample_cap}")
        self.clock = clock
        self.sample_cap = sample_cap
        self.tenant_window = tenant_window
        # per-request timing dicts: all in-flight rids + the most recent
        # ``sample_cap`` finished ones (FIFO eviction of older finished
        # entries — callers may index recently finished rids directly,
        # e.g. examples/serve_lm.py computes per-request TTFT post-run)
        self._submit: Dict[int, float] = {}
        self._first: Dict[int, float] = {}
        self._finish: Dict[int, float] = {}
        self._tokens: Dict[int, int] = {}
        self._reasons: Dict[int, str] = {}
        self._finished_order: deque = deque()
        # running totals (exact, never evicted)
        self.requests_submitted = 0
        self.requests_completed = 0
        self.total_new_tokens = 0
        self.finish_reason_counts: Dict[str, int] = {}
        # fault tolerance: failover re-submissions land here instead of
        # requests_submitted (one logical submit per request), terminal
        # typed failures and load-shed rejections are separate outcomes
        self.requests_retried = 0
        self.requests_failed = 0
        self.requests_shed = 0
        self.failure_reason_counts: Dict[str, int] = {}
        self._first_submit_ts: Optional[float] = None
        self._last_finish_ts: Optional[float] = None
        # gauges: running aggregates (exact) — sampled on decode steps
        self.max_slots: int = 0
        self.decode_steps: int = 0
        self._queue_sum = 0
        self._queue_samples = 0
        self._queue_peak = 0
        self._occ_sum = 0
        # prefix cache (zero everywhere when the cache is disabled)
        self.prefix_hits: int = 0
        self.prefix_misses: int = 0
        self.cached_tokens_served: int = 0
        self.prompt_tokens: int = 0
        self.prefix_evictions: int = 0
        # prefill work split: real prompt tokens vs what the compiled
        # chunk programs executed (chunk + batch-row padding included),
        # so co-admission padding overhead is visible, not silently
        # folded into the FLOPs proxy
        self.prefill_tokens_real: int = 0
        self.prefill_tokens_executed: int = 0
        # decode-step latency jitter: gaps between consecutive decode
        # steps — the inter-token latencies every running sequence
        # experiences, the number SplitFuse-style interleaving exists to
        # bound.  Stored in seconds; count/mean/max are all-time.
        self.decode_gaps = SlidingWindow(sample_cap)
        self._last_step_ts: Optional[float] = None
        # queue wait (submit -> first admit), ms
        self.queue_wait_ms = SlidingWindow(sample_cap)
        # prefill-budget accounting (interleaved scheduling): per
        # budgeted round, executed tokens vs the configured budget
        self.budget_rounds: int = 0
        self.budget_tokens_executed: int = 0
        self.budget_tokens_cap: int = 0
        # per-tenant rollups
        self.tenants: Dict[str, TenantStats] = {}
        self._tenant_of: Dict[int, str] = {}      # in-flight rids only
        self._admitted: set = set()               # rids past first admit
        self._last_tok_ts: Dict[int, float] = {}  # in-flight decode rows

    # -- recording -----------------------------------------------------------

    def _tenant(self, tenant: str) -> TenantStats:
        ts = self.tenants.get(tenant)
        if ts is None:
            ts = self.tenants[tenant] = TenantStats(self.tenant_window)
        return ts

    def record_submit(self, rid: int, tenant: str = "default",
                      retry: bool = False) -> None:
        """``retry=True`` is a failover re-submission of a request this
        *fleet* already counted: it gets a fresh timing entry (its queue
        wait and serving span here are real) but increments
        ``requests_retried`` instead of the logical submit counters, so
        merged summaries count one submit per request."""
        now = self.clock()
        self._submit[rid] = now
        if retry:
            self.requests_retried += 1
        else:
            self.requests_submitted += 1
            self._tenant(tenant).submitted += 1
        if self._first_submit_ts is None or now < self._first_submit_ts:
            self._first_submit_ts = now
        self._tenant_of[rid] = tenant
        t = self._tenant(tenant)
        if t.first_submit_ts is None or now < t.first_submit_ts:
            t.first_submit_ts = now

    def record_admit(self, rid: int) -> None:
        """First admission of ``rid``: queue wait = submit -> now.  A
        re-admit after preemption is not a queue wait and is ignored."""
        if rid in self._admitted or rid not in self._submit:
            return
        self._admitted.add(rid)
        wait_ms = (self.clock() - self._submit[rid]) * 1e3
        self.queue_wait_ms.add(wait_ms)
        tenant = self._tenant_of.get(rid)
        if tenant is not None:
            self._tenant(tenant).queue_wait_ms.add(wait_ms)

    def record_first_token(self, rid: int) -> None:
        now = self.clock()
        self._first[rid] = now
        self._last_tok_ts[rid] = now
        sub = self._submit.get(rid)
        tenant = self._tenant_of.get(rid)
        if sub is not None and tenant is not None:
            self._tenant(tenant).ttft_ms.add((now - sub) * 1e3)

    def record_decode_tokens(self, rids: Iterable[int]) -> None:
        """One decode step emitted a token for each of ``rids``: record
        the per-request inter-token gap into its tenant's window."""
        now = self.clock()
        for rid in rids:
            last = self._last_tok_ts.get(rid)
            self._last_tok_ts[rid] = now
            if last is None:
                continue
            tenant = self._tenant_of.get(rid)
            if tenant is not None:
                self._tenant(tenant).gap_ms.add((now - last) * 1e3)

    def record_finish(self, rid: int, n_tokens: int, reason: str) -> None:
        now = self.clock()
        first_finish = rid not in self._finish
        self._finish[rid] = now
        self._tokens[rid] = n_tokens
        self._reasons[rid] = reason
        if not first_finish:
            return
        self._finished_order.append(rid)
        self.requests_completed += 1
        self.total_new_tokens += n_tokens
        self.finish_reason_counts[reason] = (
            self.finish_reason_counts.get(reason, 0) + 1)
        if self._last_finish_ts is None or now > self._last_finish_ts:
            self._last_finish_ts = now
        tenant = self._tenant_of.pop(rid, None)
        if tenant is not None:
            t = self._tenant(tenant)
            t.completed += 1
            t.new_tokens += n_tokens
            if t.last_finish_ts is None or now > t.last_finish_ts:
                t.last_finish_ts = now
        self._admitted.discard(rid)
        self._last_tok_ts.pop(rid, None)
        while len(self._finished_order) > self.sample_cap:
            old = self._finished_order.popleft()
            for d in (self._submit, self._first, self._finish,
                      self._tokens, self._reasons):
                d.pop(old, None)

    def record_failed(self, reason: str) -> None:
        """Terminal typed failure: retry budget exhausted or no replica
        left.  Failed requests never touch the completion counters or
        the latency percentiles — they are a separate outcome."""
        self.requests_failed += 1
        self.failure_reason_counts[reason] = (
            self.failure_reason_counts.get(reason, 0) + 1)

    def record_shed(self, tenant: str) -> None:
        """A submit was rejected (Overloaded) by the degradation
        ladder; the request never entered any queue."""
        self.requests_shed += 1
        self.failure_reason_counts[f"shed:{tenant}"] = (
            self.failure_reason_counts.get(f"shed:{tenant}", 0) + 1)

    def record_prefix(self, cached_tokens: int, prompt_tokens: int) -> None:
        """One admission's prefix-cache outcome: how many of the prompt's
        tokens were served from the store instead of recomputed."""
        if cached_tokens > 0:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        self.cached_tokens_served += cached_tokens
        self.prompt_tokens += prompt_tokens

    def record_prefill_work(self, real: int, executed: int) -> None:
        """One admission batch's prefill accounting: ``real`` prompt
        tokens computed vs ``executed`` token positions the compiled
        programs ran (the difference is padding)."""
        self.prefill_tokens_real += real
        self.prefill_tokens_executed += executed

    def record_budget(self, executed: int, budget: int) -> None:
        """One budgeted prefill round: ``executed`` token positions ran
        against a cap of ``budget`` (utilization may exceed 1.0 — the
        first chunk round of a step always runs whole)."""
        self.budget_rounds += 1
        self.budget_tokens_executed += executed
        self.budget_tokens_cap += budget

    def sample_gauges(self, queue_depth: int, active: int,
                      max_slots: int) -> None:
        self._queue_sum += queue_depth
        self._queue_samples += 1
        if queue_depth > self._queue_peak:
            self._queue_peak = queue_depth
        self._occ_sum += active
        self.max_slots = max_slots
        self.decode_steps += 1
        now = self.clock()
        if self._last_step_ts is not None:
            self.decode_gaps.add(now - self._last_step_ts)
        self._last_step_ts = now

    # -- reduction -----------------------------------------------------------

    def ttft_s(self) -> List[float]:
        return [self._first[r] - self._submit[r] for r in self._first
                if r in self._submit]

    def latency_s(self) -> List[float]:
        return [self._finish[r] - self._submit[r] for r in self._finish
                if r in self._submit]

    def decode_gaps_s(self) -> List[float]:
        """Inter-token gaps: time between consecutive decode steps (the
        windowed ring — all-time count/max live on ``decode_gaps``).  An
        admission wave's prefill runs between two decode steps, so a
        wave-at-once stall shows up as one huge gap here."""
        return list(self.decode_gaps.ring)

    def summary(self) -> Dict[str, object]:
        ttft, lat = self.ttft_s(), self.latency_s()
        span = ((self._last_finish_ts - self._first_submit_ts)
                if self._last_finish_ts is not None
                and self._first_submit_ts is not None else 0.0)
        occ = (self._occ_sum / (self._queue_samples
                                * max(self.max_slots, 1))
               if self._queue_samples else 0.0)
        return {
            "requests_completed": self.requests_completed,
            "requests_submitted": self.requests_submitted,
            "requests_retried": self.requests_retried,
            "requests_failed": self.requests_failed,
            "requests_shed": self.requests_shed,
            "failure_reasons": dict(self.failure_reason_counts),
            "total_new_tokens": self.total_new_tokens,
            "tokens_per_s": (self.total_new_tokens / span
                             if span > 0 else 0.0),
            "decode_steps": self.decode_steps,
            "ttft_ms": {"p50": _pct(ttft, 0.5) * 1e3,
                        "p95": _pct(ttft, 0.95) * 1e3,
                        "mean": (sum(ttft) / len(ttft) * 1e3
                                 if ttft else 0.0)},
            "latency_ms": {"p50": _pct(lat, 0.5) * 1e3,
                           "p95": _pct(lat, 0.95) * 1e3},
            "queue_depth": {"mean": (self._queue_sum / self._queue_samples
                                     if self._queue_samples else 0.0),
                            "peak": self._queue_peak},
            "queue_wait_ms": self.queue_wait_ms.summary(),
            "slot_occupancy": occ,
            "finish_reasons": dict(self.finish_reason_counts),
            "prefill_tokens": {
                "real": self.prefill_tokens_real,
                "executed": self.prefill_tokens_executed,
                "padding": (self.prefill_tokens_executed
                            - self.prefill_tokens_real),
                "padding_fraction": (
                    (self.prefill_tokens_executed - self.prefill_tokens_real)
                    / max(self.prefill_tokens_executed, 1)),
            },
            "decode_gap_ms": self._decode_gap_summary(),
            "prefill_budget": {
                "rounds": self.budget_rounds,
                "tokens_executed": self.budget_tokens_executed,
                "utilization": (self.budget_tokens_executed
                                / max(self.budget_tokens_cap, 1)),
            },
            "prefix_cache": {
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "hit_rate": (self.prefix_hits
                             / max(self.prefix_hits + self.prefix_misses, 1)),
                "cached_tokens_served": self.cached_tokens_served,
                "prompt_tokens": self.prompt_tokens,
                "cached_token_fraction": (self.cached_tokens_served
                                          / max(self.prompt_tokens, 1)),
                "evictions": self.prefix_evictions,
            },
            "tenants": {name: t.summary()
                        for name, t in sorted(self.tenants.items())},
        }

    def _decode_gap_summary(self) -> Dict[str, float]:
        g = self.decode_gaps
        return {
            "p50": g.percentile(0.5) * 1e3,
            "p95": g.percentile(0.95) * 1e3,
            "max": g.peak * 1e3,
            "mean": g.mean * 1e3 if g.count else 0.0,
            "count": g.count,
        }

    def to_json(self, **extra) -> str:
        return json.dumps({**self.summary(), **extra}, indent=2,
                          sort_keys=True)

    def export(self, path, **extra) -> Path:
        return atomic_write_json(path, {**self.summary(), **extra})


def merge_summaries(summaries: List[Dict[str, object]]) -> Dict[str, object]:
    """Aggregate per-replica summaries into gateway-level totals.

    Edge cases are contractual: an empty list returns the explicit
    ``{"replicas": 0}`` sentinel (not ``{}``, not an exception), and a
    single-replica list passes through its numbers unchanged — partial
    summaries (an idle replica, a hand-built dict missing sections)
    merge with zero defaults instead of raising or emitting NaN."""
    if not summaries:
        return {"replicas": 0}
    total_tokens = sum(s.get("total_new_tokens", 0) for s in summaries)
    pc = [s["prefix_cache"] for s in summaries if "prefix_cache" in s]
    hits = sum(p["hits"] for p in pc)
    misses = sum(p["misses"] for p in pc)
    cached = sum(p["cached_tokens_served"] for p in pc)
    prompt = sum(p["prompt_tokens"] for p in pc)
    pf = [s["prefill_tokens"] for s in summaries if "prefill_tokens" in s]
    pf_real = sum(p["real"] for p in pf)
    pf_exec = sum(p["executed"] for p in pf)
    # jitter percentiles: only replicas that actually decoded carry
    # gaps.  A replica with zero decode steps (or one step — no gap)
    # reports count 0 and must contribute NOTHING: folding its 0.0
    # percentiles into a mean (or counting it in the denominator) would
    # dilute the fleet's jitter numbers — the double-counting bug class
    # this merge had with prefix stats.  Percentile merge is the
    # conservative cross-replica bound (max); the mean is weighted by
    # each replica's gap count.
    dg = [s["decode_gap_ms"] for s in summaries
          if s.get("decode_gap_ms", {}).get("count", 0) > 0]
    n_gaps = sum(d["count"] for d in dg)
    decode_gap = {
        "p50": max((d["p50"] for d in dg), default=0.0),
        "p95": max((d["p95"] for d in dg), default=0.0),
        "max": max((d["max"] for d in dg), default=0.0),
        "mean": (sum(d["mean"] * d["count"] for d in dg) / n_gaps
                 if n_gaps else 0.0),
        "count": n_gaps,
    }
    # budget utilization weighted by budgeted rounds, same rationale
    pb = [s["prefill_budget"] for s in summaries
          if s.get("prefill_budget", {}).get("rounds", 0) > 0]
    pb_rounds = sum(b["rounds"] for b in pb)
    pb_exec = sum(b["tokens_executed"] for b in pb)
    pb_util = (sum(b["utilization"] * b["rounds"] for b in pb) / pb_rounds
               if pb_rounds else 0.0)
    return {
        "decode_gap_ms": decode_gap,
        "prefill_budget": {"rounds": pb_rounds,
                           "tokens_executed": pb_exec,
                           "utilization": pb_util},
        "prefill_tokens": {
            "real": pf_real, "executed": pf_exec,
            "padding": pf_exec - pf_real,
            "padding_fraction": (pf_exec - pf_real) / max(pf_exec, 1),
        },
        "prefix_cache": {
            "hits": hits, "misses": misses,
            "hit_rate": hits / max(hits + misses, 1),
            "cached_tokens_served": cached,
            "prompt_tokens": prompt,
            "cached_token_fraction": cached / max(prompt, 1),
            "evictions": sum(p["evictions"] for p in pc),
        },
        "replicas": len(summaries),
        "requests_completed": sum(s.get("requests_completed", 0)
                                  for s in summaries),
        # fault-tolerance outcomes: a retried request contributed one
        # requests_submitted (on its first replica) and one retry per
        # re-route — summing keeps the one-logical-submit invariant
        "requests_submitted": sum(s.get("requests_submitted", 0)
                                  for s in summaries),
        "requests_retried": sum(s.get("requests_retried", 0)
                                for s in summaries),
        "requests_failed": sum(s.get("requests_failed", 0)
                               for s in summaries),
        "requests_shed": sum(s.get("requests_shed", 0) for s in summaries),
        "total_new_tokens": total_tokens,
        "tokens_per_s": sum(s.get("tokens_per_s", 0.0) for s in summaries),
        "decode_steps": sum(s.get("decode_steps", 0) for s in summaries),
        "ttft_ms_p95": max((s.get("ttft_ms", {}).get("p95", 0.0)
                            for s in summaries), default=0.0),
        "latency_ms_p95": max((s.get("latency_ms", {}).get("p95", 0.0)
                               for s in summaries), default=0.0),
        "slot_occupancy": (sum(s.get("slot_occupancy", 0.0)
                               for s in summaries) / len(summaries)),
        # per-tenant rollups: tenants union across replicas (disjoint
        # keys pass through); overlapping tenants merge window-wise —
        # zero-count windows (an idle or zero-decode replica) contribute
        # nothing, extending the jitter-dilution regression to tenants
        "tenants": merge_tenant_summaries(
            [s.get("tenants", {}) for s in summaries]),
    }
