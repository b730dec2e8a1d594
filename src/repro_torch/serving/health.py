"""Replica health tracking for the serving gateway (the port's copy of
``repro.serving.health``: the same states, thresholds and defaults).

One :class:`HealthMonitor` per replica, fed by the gateway after every
gateway step with the one signal a wedged capsule cannot fake: *did the
scheduler's observable state change* (progress signature), plus any
exception ``step()`` raised.  The state machine is the usual membership
ladder —

    HEALTHY -> DEGRADED -> QUARANTINED        (consecutive bad steps)
    any     -> DEAD                           (fatal error, permanent)
    DEGRADED -> HEALTHY                       (progress resumed)
    QUARANTINED -> HEALTHY                    (rejoin after cooldown)

— and every transition is **edge-triggered**: ``record_step`` /
``record_failure`` return a transition dict exactly when the state
changed (the gateway turns it into one ``replica_health`` trace event),
never a per-step alarm flood.  DEAD is terminal for automatic handling:
a crashed capsule does not flap back; only an explicit gateway
``rejoin`` (the capsule-relaunch path) revives a QUARANTINED replica.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
DEAD = "dead"

HEALTH_STATES = (HEALTHY, DEGRADED, QUARANTINED, DEAD)


@dataclass(frozen=True)
class HealthConfig:
    """Thresholds in *consecutive bad gateway steps* (a bad step is an
    exception or a no-progress step while work was pending)."""
    degraded_after: int = 2        # HEALTHY -> DEGRADED
    quarantine_after: int = 4      # DEGRADED -> QUARANTINED
    rejoin_cooldown_steps: int = 8   # QUARANTINED -> rejoin eligibility
    auto_rejoin: bool = True

    def __post_init__(self):
        if self.degraded_after <= 0 or self.quarantine_after <= 0:
            raise ValueError("health thresholds must be positive")
        if self.quarantine_after <= self.degraded_after:
            raise ValueError(
                f"quarantine_after ({self.quarantine_after}) must exceed "
                f"degraded_after ({self.degraded_after})")
        if self.rejoin_cooldown_steps < 0:
            raise ValueError("rejoin_cooldown_steps must be >= 0")


class HealthMonitor:
    """Edge-triggered per-replica health state machine."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.state = HEALTHY
        self.consecutive_bad = 0
        self.failures = 0              # exceptions observed (all-time)
        self.stalls = 0                # no-progress steps (all-time)
        self.rejoins = 0
        self.last_error = ""
        self.transitions: List[Dict[str, object]] = []

    @property
    def routable(self) -> bool:
        """May receive new work (QUARANTINED/DEAD replicas may not)."""
        return self.state in (HEALTHY, DEGRADED)

    @property
    def alive(self) -> bool:
        return self.state != DEAD

    # -- observations --------------------------------------------------------

    def record_step(self, made_progress: bool
                    ) -> Optional[Dict[str, object]]:
        """One gateway step on a routable replica with pending work:
        returns the transition this observation caused, or None."""
        if made_progress:
            self.consecutive_bad = 0
            if self.state == DEGRADED:
                return self._to(HEALTHY, "progress_resumed")
            return None
        self.stalls += 1
        return self._bad("no_progress")

    def record_failure(self, error: str, fatal: bool = False
                       ) -> Optional[Dict[str, object]]:
        """``step()`` raised.  ``fatal`` (a crashed capsule) goes
        straight to DEAD; transient errors climb the ladder."""
        self.failures += 1
        self.last_error = error
        if fatal:
            return self._to(DEAD, f"crashed: {error}")
        return self._bad(f"step_error: {error}")

    def mark_rejoined(self) -> Dict[str, object]:
        """The gateway relaunched this (QUARANTINED) replica."""
        assert self.state == QUARANTINED, \
            f"rejoin from {self.state}, expected {QUARANTINED}"
        self.rejoins += 1
        self.consecutive_bad = 0
        tr = self._to(HEALTHY, "rejoin")
        assert tr is not None
        return tr

    # -- internals -----------------------------------------------------------

    def _bad(self, reason: str) -> Optional[Dict[str, object]]:
        self.consecutive_bad += 1
        cfg = self.config
        if (self.state == HEALTHY
                and self.consecutive_bad >= cfg.degraded_after):
            return self._to(DEGRADED, reason)
        if (self.state == DEGRADED
                and self.consecutive_bad >= cfg.quarantine_after):
            return self._to(QUARANTINED, reason)
        return None

    def _to(self, new: str, reason: str) -> Optional[Dict[str, object]]:
        if new == self.state:
            return None
        tr = {"from": self.state, "to": new, "reason": reason,
              "consecutive_bad": self.consecutive_bad}
        self.state = new
        self.transitions.append(tr)
        return tr

    def summary(self) -> Dict[str, object]:
        return {"state": self.state, "failures": self.failures,
                "stalls": self.stalls, "rejoins": self.rejoins,
                "transitions": len(self.transitions),
                "last_error": self.last_error}
