"""Deterministic fault injection for the serving fleet (the port's copy
of ``repro.serving.faults``: the same specs, the same seeded streams, the
same schedules from the same seed).

The source paper's deployments are long-lived containerized jobs on a
batch-scheduled HPC system: nodes fail, allocations get preempted, a
capsule wedges without exiting.  Testing the gateway's failure handling
against *real* failures is neither deterministic nor CI-friendly, so
this module provides the seeded stand-in: a :class:`FaultPlan` describes
*what goes wrong where and when*, and per-replica :class:`FaultInjector`
instances replay it — bit-identically across runs — through explicit
hooks in :class:`~repro_torch.serving.scheduler.Scheduler` (``step()``) and
:class:`~repro_torch.serving.engine.ServingEngine` (``advance_prefill`` /
``decode_once``).

Fault kinds (``FaultSpec.kind``):

``raise``
    The hook raises :class:`InjectedFault` (a transient error) for
    ``duration`` consecutive firings.  The scheduler's existing error
    paths requeue any in-flight work, so a transient raise costs retries
    but never loses a request.
``stall``
    ``Scheduler.step()`` reports progress (returns True) while doing
    *nothing* for ``duration`` steps — the wedged-capsule shape that
    return-value-based liveness checks cannot see.  Only the gateway's
    progress-signature watchdog catches it.
``crash``
    Permanent: the hook raises :class:`ReplicaCrashed` on this and every
    later firing (``reset()`` after a capsule relaunch clears it).  The
    gateway marks the replica DEAD and fails over.
``slow``
    The hook sleeps ``latency_s`` per firing for ``duration`` firings —
    the degraded-node shape that trips SLO breaches, not health checks.

Scheduling is by replica-local step index (``at_step``) and/or a
per-firing ``probability`` drawn from a deterministic per-replica
stream, so a whole fleet's fault schedule replays identically from one
``FaultPlan(seed=...)``.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("raise", "stall", "crash", "slow")
FAULT_SITES = ("step", "prefill", "decode")


class InjectedFault(RuntimeError):
    """A transient injected failure (the replica can recover)."""


class ReplicaCrashed(RuntimeError):
    """A permanent injected failure: every later hook firing raises
    again, like a process that died — only ``FaultInjector.reset()``
    (the capsule-relaunch analogue) brings the replica back."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``replica`` is a name or ``"*"`` (all);
    the fault arms at replica-local step ``at_step`` (None = armed from
    step 0) and, once armed, fires with ``probability`` per step (1.0 =
    fire deterministically the step it arms)."""
    kind: str
    replica: str = "*"
    at_step: Optional[int] = None
    probability: float = 1.0
    duration: int = 1                  # firings (ignored by crash)
    latency_s: float = 0.0             # slow only
    site: str = "step"                 # step | prefill | decode

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {FAULT_SITES}")
        if self.kind in ("stall", "slow") and self.site != "step":
            raise ValueError(f"{self.kind} faults only make sense at "
                             f"site='step' (got {self.site!r})")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], "
                             f"got {self.probability}")
        if self.duration <= 0:
            raise ValueError(f"duration must be positive, "
                             f"got {self.duration}")
        if self.kind == "slow" and self.latency_s <= 0.0:
            raise ValueError("slow faults need latency_s > 0")


@dataclass
class FaultPlan:
    """A seeded fleet-wide fault schedule.  One plan hands out one
    :class:`FaultInjector` per replica (``injector_for``); two plans
    with equal specs and seed replay identical schedules."""
    specs: Sequence[FaultSpec] = field(default_factory=tuple)
    seed: int = 0

    def injector_for(self, replica: str) -> "FaultInjector":
        mine = [s for s in self.specs
                if s.replica in ("*", replica)]
        return FaultInjector(mine, seed=self.seed, replica=replica)

    @classmethod
    def random(cls, seed: int, replicas: Sequence[str], n_faults: int = 3,
               max_step: int = 20,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """A randomized-but-deterministic plan for chaos harnesses:
        ``n_faults`` specs drawn over ``replicas``, armed within
        ``max_step`` replica-local steps."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            site = "step"
            if kind in ("raise", "crash"):
                site = str(rng.choice(FAULT_SITES))
            specs.append(FaultSpec(
                kind=kind,
                replica=str(rng.choice(list(replicas))),
                at_step=int(rng.integers(1, max_step)),
                duration=int(rng.integers(1, 4)),
                latency_s=1e-3 if kind == "slow" else 0.0,
                site=site))
        return cls(tuple(specs), seed=seed)


class FaultInjector:
    """Per-replica replay of a :class:`FaultPlan` slice.

    The scheduler calls :meth:`on_step` at the top of every ``step()``;
    the engine calls :meth:`on_engine_op` at the top of
    ``advance_prefill`` / ``decode_once``.  Both either return/no-op,
    sleep (slow), or raise (:class:`InjectedFault` /
    :class:`ReplicaCrashed`).  The probability stream is seeded from
    ``(plan seed, replica name)`` so schedules are independent across
    replicas yet fully reproducible.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: int = 0,
                 replica: str = "replica0", sleep=time.sleep):
        self.specs = list(specs)
        self.seed = seed
        self.replica = replica
        self._sleep = sleep
        self.fired: List[Tuple[int, str, str]] = []   # (step, kind, site)
        self.reset()

    def reset(self) -> "FaultInjector":
        """Capsule-relaunch analogue: clears the crashed flag and all
        firing windows, restarts the step index and the probability
        stream (the relaunched process replays its schedule afresh)."""
        self.step_index = 0
        self.crashed = False
        self._rng = np.random.default_rng(
            (self.seed << 16) ^ zlib.crc32(self.replica.encode()))
        self._remaining = [s.duration for s in self.specs]
        return self

    # -- firing logic --------------------------------------------------------

    def _fire(self, spec: FaultSpec, i: int, step: int, site: str) -> str:
        self._remaining[i] -= 1
        self.fired.append((step, spec.kind, site))
        if spec.kind == "crash":
            self.crashed = True
            raise ReplicaCrashed(
                f"{self.replica}: injected crash at step {step} ({site})")
        if spec.kind == "raise":
            raise InjectedFault(
                f"{self.replica}: injected transient fault at step "
                f"{step} ({site})")
        if spec.kind == "slow":
            self._sleep(spec.latency_s)
            return "ok"
        return "stall"

    def _scan(self, step: int, site: str) -> str:
        outcome = "ok"
        for i, spec in enumerate(self.specs):
            if spec.site != site or self._remaining[i] <= 0:
                continue
            if spec.at_step is not None and step < spec.at_step:
                continue
            if (spec.probability < 1.0
                    and float(self._rng.random()) >= spec.probability):
                continue
            if self._fire(spec, i, step, site) == "stall":
                outcome = "stall"
        return outcome

    def on_step(self) -> str:
        """Scheduler hook.  Returns ``"stall"`` (the scheduler must
        return True without touching any state) or ``"ok"``; raises for
        raise/crash faults.  Advances the replica-local step index —
        even when the step raises, so a transient fault is not replayed
        forever against the same step."""
        if self.crashed:
            raise ReplicaCrashed(
                f"{self.replica}: capsule is down (crashed earlier)")
        step = self.step_index
        self.step_index += 1
        return self._scan(step, "step")

    def on_engine_op(self, site: str) -> None:
        """Engine hook (``site`` is ``"prefill"`` or ``"decode"``);
        raises for raise/crash faults scheduled at that site."""
        if self.crashed:
            raise ReplicaCrashed(
                f"{self.replica}: capsule is down (crashed earlier)")
        self._scan(self.step_index, site)
