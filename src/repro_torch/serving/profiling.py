"""In-process performance profiling for the serving stack (host side).

* :class:`StepProfiler` — step-phase timing.  The scheduler's phase
  timestamps normally measure *dispatch* (CUDA launches are async); with
  profiling on, the scheduler brackets each phase with
  ``torch.cuda.synchronize()`` so the deltas are wall time the device
  actually spent in admit / prefill / decode / sample.  Windows are
  bounded (:class:`~repro_torch.serving.slo.SlidingWindow`).

* :class:`RecompilationTracker` — shape-signature telemetry.  Each of
  the engine's round programs (``serving/programs.py``) has fixed
  shapes, and its "compile" is its build at its first round: on the card
  a CUDA-graph capture, on the CPU the first run into its static output.
  The engine reports each program's argument signature here, so a build
  is a program's first signature, and a serving loop whose batch
  dimension wobbles (sizing the decode batch to the number of *live*
  slots instead of padding to ``max_slots``) shows up as signature churn,
  exactly as it does in the reference.  Any novel signature after
  :meth:`~RecompilationTracker.mark_warm` (a capture there included, or
  beyond the first one per program) emits a ``recompile`` warning event
  through the tracer.

Per-kernel device timing lives in ``chip_smoke.py`` (CUDA events at the
main path's shapes); the reference's XLA ``cost_analysis`` profiles have
no counterpart here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serving.slo import SlidingWindow

PHASES = ("admit", "prefill", "decode", "sample")


class StepProfiler:
    """Bounded per-phase timing windows, fed by ``Scheduler.step()``
    when the scheduler is constructed with ``profile=True``."""

    def __init__(self, window: int = 512):
        self.phases: Dict[str, SlidingWindow] = {
            p: SlidingWindow(window) for p in PHASES}
        self.steps = 0

    def record_step(self, admit_s: float, prefill_s: float,
                    decode_s: float, sample_s: float) -> None:
        self.steps += 1
        for name, dur in zip(PHASES, (admit_s, prefill_s,
                                      decode_s, sample_s)):
            self.phases[name].add(dur * 1e3)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {"steps": self.steps}
        for name, win in self.phases.items():
            out[f"{name}_ms"] = win.summary()
        return out


class RecompilationTracker:
    """Shape-signature counter for the engine's programs.  ``observe``
    is on the hot path — one tuple hash and one set lookup per call —
    and only does real work on a novel signature."""

    def __init__(self):
        self.signatures: Dict[str, set] = {}
        self.post_warm: Dict[str, int] = {}
        self.warm = False

    def mark_warm(self) -> None:
        """Declare warmup over: every later novel signature is a
        *post-warm recompile* — shape churn, the thing steady-state
        serving must never do."""
        self.warm = True

    def observe(self, program: str, signature: Tuple,
                tracer=None) -> bool:
        """Record one invocation of ``program`` with argument shape
        ``signature``.  Returns True when the signature is new.  Beyond
        each program's first signature — or any novel signature after
        :meth:`mark_warm` — a ``recompile`` warning event goes through
        ``tracer``."""
        sigs = self.signatures.setdefault(program, set())
        if signature in sigs:
            return False
        sigs.add(signature)
        if self.warm:
            self.post_warm[program] = self.post_warm.get(program, 0) + 1
        if tracer is not None and (self.warm or len(sigs) > 1):
            tracer.recompile(program, repr(signature), len(sigs),
                             post_warm=self.warm)
        return True

    @property
    def post_warm_recompiles(self) -> int:
        return sum(self.post_warm.values())

    def compiles(self, program: Optional[str] = None) -> int:
        if program is not None:
            return len(self.signatures.get(program, ()))
        return sum(len(s) for s in self.signatures.values())

    def churning_programs(self, threshold: int = 3) -> List[str]:
        """Programs with suspiciously many signatures — the triage list:
        find which argument's shape wobbles and pad it."""
        return sorted(p for p, s in self.signatures.items()
                      if len(s) >= threshold or self.post_warm.get(p, 0))

    def summary(self) -> Dict[str, object]:
        return {
            "warm": self.warm,
            "compiles_total": self.compiles(),
            "post_warm_recompiles": self.post_warm_recompiles,
            "programs": {p: {"signatures": len(s),
                             "post_warm": self.post_warm.get(p, 0)}
                         for p, s in sorted(self.signatures.items())},
            "churning": self.churning_programs(),
        }
