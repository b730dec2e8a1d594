"""The device trace of a traced run, from ``torch.profiler`` (CUPTI).

A ``Slice`` profiles the last stretch of the measured window (it stops
after the window has closed, so the profiler's own collection is never
timed): every operation that ran on the card (kernels, copies, sets;
kernels replayed from CUDA graphs come as kernels of their own; the
ranges' own annotations on the device timeline are left out) and the
benchmark's own host spans
(``record_function`` ranges named ``bench.*``) around its calls into the
program.  From them: the seconds in which the card was busy, the device
operations that took most time, and the idle gaps, each labelled by the
innermost benchmark span that covered it (what the host was doing).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

STEP = "bench.step"


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments or
    parameter list."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    return base.split("<")[0].strip() or name[:80]


class Slice:
    """Profile from :meth:`start` to :meth:`stop` (call both at step
    boundaries); then ``kernels`` holds ``(name, start_ns, end_ns)`` of
    every device operation, ``spans`` the ``bench.*`` host ranges, and
    ``window`` runs from the first traced step's start to the last one's
    end (each step is a ``bench.step`` range)."""

    def __init__(self):
        self.kernels: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        self.window: Optional[Tuple[int, int]] = None
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        # a record_function range shows on the device timeline too, under
        # its host name: a device event named as a host event is one
        host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.name() not in host:
                    self.kernels.append((e.name(), start, end))
            elif e.name().startswith("bench."):
                self.spans.append((e.name(), start, end))
        self._prof = None
        self.kernels.sort(key=lambda k: k[1])
        steps = [(s, e) for n, s, e in self.spans if n == STEP]
        if steps:
            self.window = (min(s for s, _ in steps), max(e for _, e in steps))
        elif self.kernels:
            # no host range reached the trace: the device operations' span
            self.window = (self.kernels[0][1],
                           max(e for _, _, e in self.kernels))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        merged: List[List[int]] = []
        for _, s, e in self.kernels:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    def kernel_ns(self, name: str) -> Tuple[int, int]:
        """(calls, summed device ns) of the kernels whose name holds
        ``name``."""
        hits = [e - s for k, s, e in self.kernels if name in k]
        return len(hits), sum(hits)

    def following_ns(self, name: str, after: str) -> Tuple[int, int]:
        """(calls, summed ns) of the ``name`` kernels that come straight
        after an ``after`` kernel on the timeline (the combine launch of a
        split kernel)."""
        n = ns = 0
        prev = ""
        for k, s, e in self.kernels:
            if name in k and after in prev:
                n += 1
                ns += e - s
            prev = k
        return n, ns

    def device_ops(self, top: int = 10) -> List[List]:
        by = defaultdict(int)
        for k, s, e in self.kernels:
            by[_short(k)] += e - s
        return [[k, ns / 1e9] for k, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the window summed by the innermost benchmark
        span that covered each gap's middle (``"outside spans"`` where
        none did)."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self._busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        by: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) // 2
            inside = [(se - ss, n) for n, ss, se in self.spans
                      if ss <= mid <= se]
            label = min(inside)[1] if inside else "outside spans"
            by[label] += (e - s) / 1e9
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}


def warm() -> None:
    """Start and stop the profiler once, so its first start (CUPTI's set-up)
    is paid in set-up and not inside the window."""
    import torch
    s = Slice()
    s.start()
    with torch.profiler.record_function(STEP):
        torch.ones(1, device="cuda").add_(1)
    s.stop()
