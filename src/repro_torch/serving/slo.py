"""Per-tenant SLO monitoring for long-lived capsule deployments.

The source paper's deployments are *services*: a container image lands on
a secure HPC system and serves mixed traffic for months.  ROADMAP item 5
calls for per-tenant TTFT/jitter percentiles "so mixed-SLA traffic is
measurable, not just served" — this module is that measurement layer,
built entirely inside the capsule (no external monitoring stack; breach
events land in the same file-based trace exports as everything else).

Pieces, bottom-up:

* :class:`SlidingWindow` — a bounded percentile estimator.  Percentiles
  are exact over the most recent ``window`` samples (a ring — month-long
  deployments must not grow memory without bound); ``count`` / ``mean`` /
  ``max`` are running scalars over *all* samples ever added, so totals
  stay exact even after the ring wraps.  Below ``window`` samples the
  ring holds everything and percentiles are exact over the full history
  (the "exact-mode fallback").

* :class:`TenantStats` — one tenant's windows (TTFT, inter-token gap,
  queue wait, all in ms) plus running request/token counters and a
  tokens/s over the tenant's own submit→finish span.

* :class:`SLOPolicy` / :class:`SLOConfig` — declarative thresholds.  A
  config is a default policy plus per-tenant overrides, loadable from
  JSON (``launch/serve.py --slo-config``)::

      {"default": {"ttft_p95_ms": 500, "gap_p95_ms": 50},
       "tenants": {"premium": {"ttft_p95_ms": 200, "min_samples": 4}}}

* :class:`SLOMonitor` — evaluates policies against per-tenant stats and
  reports *state transitions* (enter-breach / recover), which the
  :class:`~repro_torch.serving.tracing.Tracer` emits as ``slo_breach`` events.
  Edge-triggered on purpose: a sustained breach is one event plus one
  recovery, not one event per scheduler step.

This module sits below :mod:`repro_torch.serving.metrics` in the import graph
(metrics holds the per-tenant :class:`TenantStats` and merges their
summaries) and must not import it.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Dict, List, Mapping, Optional


def _pct_of(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy-free, same formula as
    ``metrics._pct`` — duplicated to keep this module import-root)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    f = (len(s) - 1) * q
    lo, hi = int(f), min(int(f) + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (f - lo)


DEFAULT_WINDOW = 512


class SlidingWindow:
    """Bounded percentile estimator: exact percentiles over the last
    ``window`` samples, exact running count/sum/max over all samples."""

    __slots__ = ("ring", "count", "total", "peak")

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.ring: deque = deque(maxlen=window)
        self.count = 0          # all-time
        self.total = 0.0        # all-time
        self.peak = 0.0         # all-time

    @property
    def window(self) -> int:
        return self.ring.maxlen

    def add(self, x: float) -> None:
        self.ring.append(x)
        self.count += 1
        self.total += x
        if x > self.peak:
            self.peak = x

    def percentile(self, q: float) -> float:
        return _pct_of(self.ring, q)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        """``p50``/``p95`` over the window; ``max``/``mean``/``count``
        all-time (documented asymmetry: percentiles answer "how is it
        *now*", the scalars answer "what happened overall")."""
        return {"p50": self.percentile(0.5), "p95": self.percentile(0.95),
                "max": self.peak, "mean": self.mean, "count": self.count}


def merge_window_summaries(summaries: List[Mapping]) -> Dict[str, float]:
    """Cross-replica merge of :meth:`SlidingWindow.summary` dicts: counts
    sum, percentiles take the conservative bound (max), the mean is
    count-weighted.  Windows with ``count == 0`` contribute nothing — an
    idle replica must not dilate or dilute a tenant's percentiles (the
    zero-decode-replica regression, extended to tenants)."""
    live = [s for s in summaries if s.get("count", 0) > 0]
    n = sum(int(s["count"]) for s in live)
    return {
        "p50": max((float(s.get("p50", 0.0)) for s in live), default=0.0),
        "p95": max((float(s.get("p95", 0.0)) for s in live), default=0.0),
        "max": max((float(s.get("max", 0.0)) for s in live), default=0.0),
        "mean": (sum(float(s.get("mean", 0.0)) * int(s["count"])
                     for s in live) / n if n else 0.0),
        "count": n,
    }


class TenantStats:
    """One tenant's serving telemetry: bounded windows + running totals."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.ttft_ms = SlidingWindow(window)
        self.gap_ms = SlidingWindow(window)        # inter-token, per rid
        self.queue_wait_ms = SlidingWindow(window)
        self.submitted = 0
        self.completed = 0
        self.new_tokens = 0
        self.first_submit_ts: Optional[float] = None
        self.last_finish_ts: Optional[float] = None

    def tokens_per_s(self) -> float:
        if self.first_submit_ts is None or self.last_finish_ts is None:
            return 0.0
        span = self.last_finish_ts - self.first_submit_ts
        return self.new_tokens / span if span > 0 else 0.0

    def summary(self) -> Dict[str, object]:
        return {
            "requests_submitted": self.submitted,
            "requests_completed": self.completed,
            "new_tokens": self.new_tokens,
            "tokens_per_s": self.tokens_per_s(),
            "ttft_ms": self.ttft_ms.summary(),
            "decode_gap_ms": self.gap_ms.summary(),
            "queue_wait_ms": self.queue_wait_ms.summary(),
        }


def merge_tenant_summaries(per_tenant: List[Mapping[str, Mapping]]
                           ) -> Dict[str, Dict[str, object]]:
    """Merge ``{tenant: TenantStats.summary()}`` maps across replicas.
    Tenants union (disjoint keys pass through unchanged); overlapping
    keys merge window-wise via :func:`merge_window_summaries`."""
    names: List[str] = []
    for m in per_tenant:
        for name in m:
            if name not in names:
                names.append(name)
    merged: Dict[str, Dict[str, object]] = {}
    for name in sorted(names):
        ss = [m[name] for m in per_tenant if name in m]
        merged[name] = {
            "requests_submitted": sum(int(s.get("requests_submitted", 0))
                                      for s in ss),
            "requests_completed": sum(int(s.get("requests_completed", 0))
                                      for s in ss),
            "new_tokens": sum(int(s.get("new_tokens", 0)) for s in ss),
            "tokens_per_s": sum(float(s.get("tokens_per_s", 0.0))
                                for s in ss),
            "ttft_ms": merge_window_summaries(
                [s.get("ttft_ms", {}) for s in ss]),
            "decode_gap_ms": merge_window_summaries(
                [s.get("decode_gap_ms", {}) for s in ss]),
            "queue_wait_ms": merge_window_summaries(
                [s.get("queue_wait_ms", {}) for s in ss]),
        }
    return merged


# ---------------------------------------------------------------------------
# declarative policies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOPolicy:
    """Thresholds for one tenant.  ``None`` disables that check.  Upper
    bounds are on windowed p95s (ms); ``min_tokens_per_s`` is a lower
    bound on the tenant's running throughput.  ``min_samples`` gates
    every windowed check — no verdicts on thin data."""
    ttft_p95_ms: Optional[float] = None
    gap_p95_ms: Optional[float] = None
    queue_wait_p95_ms: Optional[float] = None
    min_tokens_per_s: Optional[float] = None
    min_samples: int = 8

    @classmethod
    def from_dict(cls, d: Mapping) -> "SLOPolicy":
        known = {f.name for f in fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown SLO policy keys: {sorted(bad)} "
                             f"(known: {sorted(known)})")
        return cls(**d)

    def to_dict(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None or f.name == "min_samples"}


class SLOConfig:
    """A default policy plus per-tenant overrides."""

    def __init__(self, default: Optional[SLOPolicy] = None,
                 tenants: Optional[Mapping[str, SLOPolicy]] = None):
        self.default = default or SLOPolicy()
        self.tenants: Dict[str, SLOPolicy] = dict(tenants or {})

    def policy_for(self, tenant: str) -> SLOPolicy:
        return self.tenants.get(tenant, self.default)

    @classmethod
    def from_dict(cls, d: Mapping) -> "SLOConfig":
        default = SLOPolicy.from_dict(d.get("default", {}))
        tenants = {name: SLOPolicy.from_dict(pol)
                   for name, pol in d.get("tenants", {}).items()}
        return cls(default, tenants)

    @classmethod
    def from_json(cls, path) -> "SLOConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def to_dict(self) -> Dict[str, object]:
        return {"default": self.default.to_dict(),
                "tenants": {n: p.to_dict()
                            for n, p in sorted(self.tenants.items())}}


class SLOMonitor:
    """Edge-triggered policy evaluation over per-tenant stats.

    :meth:`evaluate` compares each tenant's windowed stats against its
    policy and returns the *transitions* since the previous call — a
    check newly entering breach, or a breached check recovering.  The
    tracer turns each transition into one ``slo_breach`` event (with a
    ``recovered`` flag), so the event log records breach spans, not a
    per-step alarm flood.  Breach totals accumulate here regardless of
    whether a tracer is attached (disabled tracing still counts).
    """

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        self._state: Dict[tuple, bool] = {}   # (tenant, metric) -> breached
        self.breaches = 0                     # enter-breach transitions

    def _checks(self, tenant: str, stats: TenantStats):
        pol = self.config.policy_for(tenant)
        out = []
        for metric, win, bound in (
                ("ttft_p95_ms", stats.ttft_ms, pol.ttft_p95_ms),
                ("gap_p95_ms", stats.gap_ms, pol.gap_p95_ms),
                ("queue_wait_p95_ms", stats.queue_wait_ms,
                 pol.queue_wait_p95_ms)):
            if bound is None or win.count < pol.min_samples:
                continue
            out.append((metric, win.percentile(0.95), bound,
                        win.percentile(0.95) > bound))
        if (pol.min_tokens_per_s is not None
                and stats.completed >= pol.min_samples):
            tps = stats.tokens_per_s()
            out.append(("min_tokens_per_s", tps, pol.min_tokens_per_s,
                        tps < pol.min_tokens_per_s))
        return out

    def evaluate(self, tenants: Mapping[str, TenantStats]) -> List[dict]:
        transitions: List[dict] = []
        for tenant in sorted(tenants):
            for metric, observed, threshold, breached in self._checks(
                    tenant, tenants[tenant]):
                key = (tenant, metric)
                if breached == self._state.get(key, False):
                    continue
                self._state[key] = breached
                if breached:
                    self.breaches += 1
                transitions.append({
                    "tenant": tenant, "metric": metric,
                    "observed": observed, "threshold": threshold,
                    "recovered": not breached,
                })
        return transitions

    def active_breaches(self) -> List[Dict[str, str]]:
        return [{"tenant": t, "metric": m}
                for (t, m), breached in sorted(self._state.items())
                if breached]

    def summary(self) -> Dict[str, object]:
        return {"breaches": self.breaches,
                "active": self.active_breaches(),
                "tenant_policies": len(self.config.tenants)}
