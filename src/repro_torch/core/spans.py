"""Spans of the port's serving and training steps, on the host's clock and
on the device's.

One recorder per process, :data:`SPANS`, used by the serving stack (the
gateway, the scheduler, the engine, the :class:`~repro_torch.serving.
tracing.Tracer`) and by the train step (``distributed/stepfn.py``).

**Triggers.**  The recorder records while a ``torch.profiler`` session
records (``torch.autograd.profiler._is_profiler_enabled``) or while a span
site drives it: a serving step whose Tracer is enabled, or whose scheduler
was built with ``profile=True``.  Otherwise a site costs a flag read or
two and builds no object: :meth:`SpanRecorder.span` and
:meth:`SpanRecorder.unit` return one shared inert context.

**Spans.**  Each span records its name, its host start and end
(``time.perf_counter_ns``, the Tracer's clock in nanoseconds), its parent
span and the step (given by the site, else the parent's).  While a
profiler records, each span also opens a ``record_function`` range of the
same name, so the profiler's trace holds it on the device trace's clock.
A step's spans serve every request in it; what belongs to one request
(its queue wait, its prefill latency) is a mark with its request id
(:meth:`SpanRecorder.mark`).

**Sessions.**  A session begins at the first site that finds recording on
after a site that found it off.  The recorder keeps the latest session
until the next begins: its last :data:`SPAN_BUFFER` spans and per-request
marks, and its running totals (:meth:`SpanRecorder.summary`).

**Device units.**  A unit is a stretch of the work a step enqueues on the
device: on a CUDA device a timing event recorded on the device's current
stream just before its first operation and one after its last; never
inside a captured program's body, so a graph replay is one unit of its own
(:meth:`SpanRecorder.replay`), its events around ``prog.replay()``.  Units
are settled once their end event has completed: by :meth:`SpanRecorder.
settle`, which waits for nothing (a serving step calls it while the card
runs its decode round, so the host work costs the card nothing, and
after its read-back; a train step at its end), and by
:meth:`SpanRecorder.summary`, which waits for the rest.  One stream runs in order, so ``elapsed(previous unit's end, this
unit's start)`` is the time the device sat idle before this unit; as it was
idle, the start event ran when the host recorded it, so the gap lies on
the host's clock over ``[t_start - gap, t_start]``.  That interval is
split over the innermost spans open in it (:func:`split_idle`;
:data:`CALLER` where none was): the host work the device waited on.  The
gap before a step's first unit reaches back to the previous step's last.
A unit's own elapsed time is the device time of its work, with any idle
inside it; a replay's is kept per program.  On the CPU the operations run
as they are called, so a unit's host interval is its device interval and
a gap is the host time between two units.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _ap

SPAN_BUFFER = 65536      # spans and marks a session keeps (oldest drop)
CALLER = "caller"        # idle while no span of the program was open


class Span:
    """One span: a context manager made only while recording is on."""

    __slots__ = ("name", "parent", "depth", "start_ns", "end_ns", "step",
                 "_rec", "_drive", "_range", "_unit")

    def __init__(self, rec: "SpanRecorder", name: str, step, drive: bool,
                 device):
        self._rec = rec
        self.name = name
        self.step = step
        self._drive = drive
        self._unit = device
        self.parent: Optional[Span] = None
        self.depth = 0
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self._range = None

    def __enter__(self) -> "Span":
        rec = self._rec
        rec._session()
        if self._drive:
            rec.driven += 1
        stack = rec.stack
        if stack:
            self.parent = stack[-1]
            self.depth = len(stack)
            if self.step is None:
                self.step = self.parent.step
        if self.step is None:
            self.step = -1
        if _ap._is_profiler_enabled:
            self._range = _ap.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        rec.spans.append(self)
        self.start_ns = time.perf_counter_ns()
        if self._unit is not None:
            self._unit = rec._unit_open(self.name, self._unit, None)
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        if self._unit is not None:
            rec._unit_close(self._unit)
        self.end_ns = time.perf_counter_ns()
        rec.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._drive:
            rec.driven -= 1


class Unit:
    """One stretch of device work (see the module's docstring)."""

    __slots__ = ("name", "span", "program", "device", "start", "end",
                 "t_start_ns", "t_end_ns")

    def __init__(self, name: str, span: str, program: Optional[str],
                 device: torch.device):
        self.name = name
        self.span = span                 # innermost span open at its start
        self.program = program           # the replayed program, if one
        self.device = device
        self.start = self.end = None     # CUDA events (None on the CPU)
        self.t_start_ns = self.t_end_ns = 0


class _Off:
    """The inert context every site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _UnitContext:
    __slots__ = ("_rec", "_args", "_unit")

    def __init__(self, rec, name, device, program):
        self._rec = rec
        self._args = (name, device, program)

    def __enter__(self):
        self._rec._session()
        self._unit = self._rec._unit_open(*self._args)
        return self._unit

    def __exit__(self, *exc) -> None:
        self._rec._unit_close(self._unit)


def split_idle(spans: Iterable[Span], a: int, b: int
               ) -> List[Tuple[str, int, int]]:
    """The host interval ``[a, b)`` (ns) cut where the innermost span open
    changes: ``[(label, start, end)]`` in order, each piece labelled with
    the name of the deepest span covering it (an open span has ``end_ns``
    None) or :data:`CALLER`; the pieces' lengths sum to ``b - a``.  Spans
    nest, so of the spans covering a piece the deepest is the one that
    started last."""
    if b <= a:
        return []
    cover = sorted((s for s in spans
                    if s.start_ns < b and (s.end_ns is None or s.end_ns > a)),
                   key=lambda s: (s.start_ns, s.depth), reverse=True)
    cuts = sorted({a, b} | {t for s in cover for t in (s.start_ns, s.end_ns)
                            if t is not None and a < t < b})
    out: List[Tuple[str, int, int]] = []
    for p, q in zip(cuts, cuts[1:]):
        label = CALLER
        for s in cover:
            if s.start_ns <= p and (s.end_ns is None or s.end_ns >= q):
                label = s.name
                break
        if out and out[-1][0] == label:
            out[-1] = (label, out[-1][1], q)
        else:
            out.append((label, p, q))
    return out


class SpanRecorder:
    """The process's span recorder (:data:`SPANS`); see the module's
    docstring."""

    def __init__(self):
        self.driven = 0                  # open spans that drive recording
        self.live = False                # the last site found recording on
        self.stack: List[Span] = []
        self._events: List = []          # CUDA events free for reuse
        self._reset()

    def _reset(self) -> None:
        self.spans: deque = deque(maxlen=SPAN_BUFFER)
        self.marks: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=SPAN_BUFFER))
        self.pending: deque = deque()
        self.idle_ns: Dict[str, int] = defaultdict(int)
        self.device_ns: Dict[str, int] = defaultdict(int)
        self.replays: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        self.units = 0
        self._last: Dict[torch.device, Tuple[object, int]] = {}

    def _session(self) -> None:
        if not self.live:
            self._reset()
            self.live = True

    # -- sites ---------------------------------------------------------------

    def span(self, name: str, step: Optional[int] = None,
             drive: bool = False, device: Optional[torch.device] = None):
        """``with SPANS.span(name):`` records a span while recording is
        on.  ``drive`` turns recording on for the span's lifetime (a
        serving step whose Tracer is enabled).  ``device``: the span is a
        device unit too, its events at the span's edges (a train phase, a
        sample call with its read-back)."""
        if not (drive or self.driven or _ap._is_profiler_enabled):
            self.live = False
            return _OFF
        return Span(self, name, step, drive, device)

    def unit(self, name: str, device: torch.device,
             program: Optional[str] = None):
        """``with SPANS.unit(name, device):`` around device work that is
        not a span of its own (a round's input copies, the logit clones)."""
        if not (self.driven or _ap._is_profiler_enabled):
            self.live = False
            return _OFF
        return _UnitContext(self, name, device, program)

    def replay(self, prog) -> torch.Tensor:
        """``prog.replay()``, a unit of its own while recording is on (its
        events around the replay alone, never in the program's body)."""
        if not (self.driven or _ap._is_profiler_enabled):
            self.live = False
            return prog.replay()
        with _UnitContext(self, prog.name, prog.device, prog.name):
            return prog.replay()

    def mark(self, name: str, value: float, rid: int = -1) -> None:
        """A per-request reading of the session (a request's queue wait,
        its prefill latency), kept beside the spans."""
        if not (self.driven or _ap._is_profiler_enabled):
            self.live = False
            return
        self._session()
        self.marks[name].append((rid, value))

    # -- units ---------------------------------------------------------------

    def _event(self):
        if self._events:
            return self._events.pop()
        return torch.cuda.Event(enable_timing=True)

    def _unit_open(self, name: str, device, program) -> Unit:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # one key per card: "cuda" and "cuda:0" are one stream's units
            device = torch.device("cuda", torch.cuda.current_device())
        u = Unit(name, self.stack[-1].name if self.stack else CALLER,
                 program, device)
        if device.type == "cuda":
            u.start = self._event()
            u.start.record(torch.cuda.current_stream(device))
        u.t_start_ns = time.perf_counter_ns()
        return u

    def _unit_close(self, u: Unit) -> None:
        if u.start is not None:
            u.end = self._event()
            u.end.record(torch.cuda.current_stream(u.device))
        u.t_end_ns = time.perf_counter_ns()
        self.pending.append(u)

    def settle(self, wait: bool = False,
               into: Optional[Dict[str, object]] = None
               ) -> Optional[Dict[str, object]]:
        """Settle the pending units whose end has completed (all of them,
        waiting, with ``wait``): add each one's device time and the idle
        gap before it to the session.  Returns what this call settled
        (added to ``into``, what an earlier call returned, if given), or
        None if nothing: ``busy_s``, ``idle_s``, ``idle_by_span`` (the gaps'
        seconds by innermost span), ``units`` (``[name, span, start, end]``
        on the host's clock in seconds) and ``gaps`` (``[label, start,
        end]``)."""
        if not self.pending:
            return into
        busy = idle = 0
        by_span: Dict[str, int] = defaultdict(int)
        units: List[list] = []
        gaps: List[list] = []
        while self.pending:
            u = self.pending[0]
            if u.end is not None and not u.end.query():
                if not wait:
                    break
                u.end.synchronize()
            self.pending.popleft()
            gap, dur, t0 = self._times(u)
            if gap:
                for label, a, b in split_idle(self._around(t0 - gap, t0),
                                              t0 - gap, t0):
                    self.idle_ns[label] += b - a
                    by_span[label] += b - a
                    gaps.append([label, a / 1e9, b / 1e9])
            idle += gap
            busy += dur
            self.units += 1
            self.device_ns[u.span] += dur
            if u.program is not None:
                r = self.replays[u.program]
                r[0] += 1
                r[1] += dur
            units.append([u.name, u.span, t0 / 1e9, (t0 + dur) / 1e9])
        if not units:
            return into
        out = into or {"busy_s": 0.0, "idle_s": 0.0, "idle_by_span": {},
                       "units": [], "gaps": []}
        out["busy_s"] += busy / 1e9
        out["idle_s"] += idle / 1e9
        for k, v in by_span.items():
            out["idle_by_span"][k] = out["idle_by_span"].get(k, 0.0) + v / 1e9
        out["units"] += units
        out["gaps"] += gaps
        return out

    def _times(self, u: Unit) -> Tuple[int, int, int]:
        """(idle ns before ``u``, its device ns, its device start on the
        host's clock), and ``u`` becomes its device's last unit."""
        last = self._last.get(u.device)
        if u.start is None:                       # the CPU: host times
            gap = 0 if last is None else max(0, u.t_start_ns - last[1])
            self._last[u.device] = (None, u.t_end_ns)
            return gap, u.t_end_ns - u.t_start_ns, u.t_start_ns
        dur = int(u.start.elapsed_time(u.end) * 1e6)
        if last is None:
            gap, t0 = 0, u.t_start_ns
        else:
            gap = max(0, int(last[0].elapsed_time(u.start) * 1e6))
            # an idle device ran the start event when the host recorded
            # it (a launch latency later: never before its idle ended)
            t0 = max(u.t_start_ns, last[1] + gap) if gap else last[1]
            self._events.append(last[0])
        self._events.append(u.start)
        self._last[u.device] = (u.end, t0 + dur)
        return gap, dur, t0

    def _around(self, a: int, b: int) -> List[Span]:
        """The session's spans that overlap ``[a, b)``: walking back from
        the newest to the first one that ended by ``a``; of the older
        spans only that one's ancestors can still reach ``a`` (spans
        nest)."""
        out = []
        for s in reversed(self.spans):
            if s.end_ns is not None and s.end_ns <= a:
                s = s.parent
                while s is not None:
                    if s.start_ns < b and (s.end_ns is None
                                           or s.end_ns > a):
                        out.append(s)
                    s = s.parent
                break
            if s.start_ns < b:
                out.append(s)
        return out

    # -- the session ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """The latest session, its pending units settled first (waiting
        for them): ``spans`` and ``units`` (counts), ``busy_s``,
        ``idle_s`` (the gaps' seconds by innermost span, :data:`CALLER`
        included), ``device_s`` (units' device seconds by the innermost
        span open at their start), ``replays`` (program -> ``[replays,
        device seconds]``) and ``marks`` (name -> values).  Empty when no
        session has recorded a span, a unit or a mark."""
        self.settle(wait=True)
        if not (self.spans or self.units or self.marks):
            return {}
        return {"spans": len(self.spans), "units": self.units,
                "busy_s": sum(self.device_ns.values()) / 1e9,
                "idle_s": {k: v / 1e9 for k, v in self.idle_ns.items()},
                "device_s": {k: v / 1e9 for k, v in self.device_ns.items()},
                "replays": {k: [n, ns / 1e9]
                            for k, (n, ns) in self.replays.items()},
                "marks": {k: [v for _, v in d]
                          for k, d in self.marks.items()}}


SPANS = SpanRecorder()
