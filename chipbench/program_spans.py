"""What the program's own span recorder (``repro_torch.core.spans``) kept
of its latest recording session, which is the traced slice: the
profiler's session turns the recorder on.  The per-layer metrics that read
it take it from here.  A program without the recorder gives an empty
session, and those metrics then find nothing to read.

The serving idle gaps come by the innermost program span the host was in
while the card waited; they fall into four layers, which together hold
every gap the recorder saw:

* ``scheduler``: the gateway's and the scheduler's own time
  (``serve.gateway_step`` and ``serve.step`` outside their children,
  ``serve.admit``, ``serve.decode.build``, ``serve.retire``);
* ``staging``: the round programs' host work around each replay
  (``serve.prefill`` and its children, ``serve.decode.feed``,
  ``serve.decode.replay``);
* ``sampling``: ``serve.sample`` and ``serve.sample.first``, each with its
  read-back;
* ``caller``: no program span open (the caller between gateway steps).
"""
from __future__ import annotations

from typing import Dict, Optional

LAYERS = ("scheduler", "staging", "sampling", "caller")


def session(ctx: Dict) -> Dict:
    """The recorder's summary of its latest session, or {}: in a run with
    no traced slice (``ctx`` has no ``trace``), with no recorder, or a
    session that recorded nothing."""
    if not ctx.get("trace"):
        return {}
    try:
        from repro_torch.core.spans import SPANS
    except ImportError:
        return {}
    return SPANS.summary()


def layer_of(label: str) -> Optional[str]:
    """The layer of an idle gap's label (a span name, or ``caller``)."""
    if label == "caller":
        return "caller"
    if label.startswith("serve.sample"):
        return "sampling"
    if label.startswith("serve.prefill") or label in (
            "serve.decode.feed", "serve.decode.replay"):
        return "staging"
    if label.startswith("serve."):
        return "scheduler"
    return None


def idle_share(layer: str, ctx: Dict) -> Optional[float]:
    """Share (%) of the traced slice (``ctx["trace"]["window_s"]``) in
    which the card was idle while the host was in ``layer``; None where
    the session holds no serving gap."""
    idle = session(ctx).get("idle_s") or {}
    t = ctx.get("trace")
    if not t or not t["window_s"] or not any(
            layer_of(k) not in (None, "caller") for k in idle):
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if layer_of(k) == layer) / t["window_s"]


def replay_ms(program: str, ctx: Dict) -> Optional[float]:
    """Mean device ms of one replay of ``program`` alone."""
    n, s = session(ctx).get("replays", {}).get(program, (0, 0.0))
    return 1e3 * s / n if n else None


def mark_p90(name: str, ctx: Dict) -> Optional[float]:
    """The 90th percentile of the session's per-request readings
    ``name``."""
    from chipbench import stats
    values = session(ctx).get("marks", {}).get(name)
    return stats.percentile(values, 90) if values else None
