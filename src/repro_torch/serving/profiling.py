"""In-process performance profiling for the serving stack.

* :class:`StepProfiler` — step-phase timing on the device's clock.  The
  scheduler's phase timestamps measure *dispatch* on the host (CUDA
  launches are async); with profiling on, every step drives the span
  recorder (``core/spans.py``), and the scheduler feeds this profiler
  each phase's device time (admit / prefill / decode / sample: the time
  of the device units that started in the phase's spans, by their CUDA
  events) and the step's device idle (the gaps before its units), with
  no synchronise.  Windows are bounded
  (:class:`~repro_torch.serving.slo.SlidingWindow`).

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

* :func:`profile_kernel` / :func:`profile_paged_kernels` — per-kernel
  profiles of the paged attention kernels at the engine's serving shapes
  and in its KV and query dtype (bf16 on the main path), with the
  reference's result keys.  The reference reads FLOPs and bytes
  from XLA's ``cost_analysis``, which has no counterpart here: they come
  from :func:`decode_cost` / :func:`prefill_cost`, the work the function
  needs for these inputs (each input byte read once, each output byte
  written once, 4 flops per (query head, attended key, dim)), the formulas
  ``chip_smoke.py`` bounds every paged kernel by.  Wall times are the
  median of ``reps`` runs, with CUDA events on the card and the host clock
  on the CPU (where the kernels run their plain versions, so only the
  structure means anything).  Peaks are the H100 SXM's (NVIDIA's data
  sheet): 3.35 TB/s of HBM, and 989 TFLOP/s for bf16 on the tensor cores
  or 67 TFLOP/s for f32 outside them, by the operands' dtype.

``chip_smoke.py`` times every kernel at the main path's shapes beside its
plain version, its library call and its bound.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.slo import SlidingWindow

HBM_BW = 3.35e12                # H100 SXM bytes/s (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor cores
              torch.float32: 67e12}     # outside the tensor cores

PHASES = ("admit", "prefill", "decode", "sample", "idle")


class StepProfiler:
    """Bounded per-phase windows of device time (ms), fed by
    ``Scheduler.step()`` when the scheduler is constructed with
    ``profile=True``; ``idle`` is the step's device idle time."""

    def __init__(self, window: int = 512):
        self.phases: Dict[str, SlidingWindow] = {
            p: SlidingWindow(window) for p in PHASES}
        self.steps = 0

    def record_step(self, admit_s: float, prefill_s: float,
                    decode_s: float, sample_s: float,
                    idle_s: float) -> None:
        self.steps += 1
        for name, dur in zip(PHASES, (admit_s, prefill_s,
                                      decode_s, sample_s, idle_s)):
            self.phases[name].add(dur * 1e3)

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {"steps": self.steps}
        for name, win in self.phases.items():
            out[f"{name}_ms"] = win.summary()
        return out


def decode_cost(case) -> Tuple[int, int]:
    """(bytes, flops) a paged decode call needs for these inputs (the
    kernel layout: ``q`` (B, KV, G, D), ``lengths``, ``window``,
    ``block_tables``): the kernel's own count,
    ``kernels.paged_attention.cost``, at the rows' lengths."""
    from repro_torch.kernels import paged_attention as pa
    return pa.cost(tuple(case["q"].shape), case["block_tables"].shape[1],
                   lengths=case["lengths"].tolist(), window=case["window"],
                   itemsize=case["q"].element_size())


def prefill_cost(case) -> Tuple[int, int]:
    """(bytes, flops) a paged prefill call needs for these inputs (``q``
    (B, KV, C*G, D), ``group``, ``start_pos``, ``q_lens``, ``window``,
    ``block_tables``): the kernel's own count,
    ``kernels.paged_prefill.cost``, at the rows' starts and lengths."""
    from repro_torch.kernels import paged_prefill as pp
    return pp.cost(tuple(case["q"].shape), case["group"],
                   case["block_tables"].shape[1],
                   starts=case["start_pos"].tolist(),
                   q_lens=case["q_lens"].tolist(), window=case["window"],
                   itemsize=case["q"].element_size())


def _wall_s(fn: Callable, args, kwargs, device: torch.device,
            clock) -> float:
    """One run's wall time: CUDA events on the card, ``clock`` on the
    CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = clock()
    fn(*args, **kwargs)
    return clock() - t0


def profile_kernel(fn: Callable, *args, name: str, flops: float,
                   bytes_accessed: float, reps: int = 5,
                   clock=time.perf_counter, **kwargs) -> Dict[str, object]:
    """Profile one kernel call at the given arguments: one warm-up run,
    then ``reps`` timed runs; reports the median wall and the achieved
    fractions of the card's peaks for ``flops`` and ``bytes_accessed``
    (the work the call needs, from :func:`decode_cost` /
    :func:`prefill_cost`).  The FLOP peak is the first tensor
    argument's dtype's."""
    first = next(a for a in args if isinstance(a, torch.Tensor))
    device = first.device
    peak = PEAK_FLOPS.get(first.dtype, PEAK_FLOPS[torch.float32])
    fn(*args, **kwargs)                           # warm-up (and any build)
    walls = sorted(_wall_s(fn, args, kwargs, device, clock)
                   for _ in range(max(reps, 1)))
    wall = walls[len(walls) // 2]
    achieved_flops = flops / wall if wall > 0 else 0.0
    achieved_bw = bytes_accessed / wall if wall > 0 else 0.0
    return {
        "name": name,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "reps": len(walls),
        "wall_ms_median": wall * 1e3,
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbps": achieved_bw / 1e9,
        "fraction_of_peak_flops": achieved_flops / peak,
        "fraction_of_peak_bw": achieved_bw / HBM_BW,
        "arithmetic_intensity": (flops / bytes_accessed
                                 if bytes_accessed > 0 else 0.0),
    }


def profile_shapes(engine) -> Dict[str, object]:
    """The keyword arguments of :func:`paged_profile_cases` for a paged
    engine: its batch width, page geometry, head layout, device and the
    dtype its KV pages and queries hold (one dtype: the kernels take q and
    pages of one)."""
    if not getattr(engine, "paged", False):
        raise ValueError("kernel profiling requires a paged engine")
    from repro_torch.serving.kvcache import _leaves
    cfg, kv = engine.cfg, engine.kv
    return dict(slots=engine.max_slots, num_blocks=kv.pool.num_blocks,
                page=kv.block_size, blocks_per_slot=kv.blocks_per_slot,
                max_seq_len=engine.max_seq_len, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, device=engine.device,
                dtype=_leaves(kv.cache)[0][1].dtype)


def paged_profile_cases(*, slots: int, num_blocks: int, page: int,
                        blocks_per_slot: int, max_seq_len: int,
                        num_heads: int, num_kv_heads: int, head_dim: int,
                        device, dtype: torch.dtype = torch.float32,
                        chunk: int = 8) -> Dict[str, dict]:
    """The operands :func:`profile_paged_kernels` times, in the kernels'
    layout: ``dtype`` (the engine's KV dtype, :func:`profile_shapes`), at a
    paged engine's serving shapes (``slots`` rows, ``num_blocks`` pages
    plus the trash page, every row's table reaching ``min(page *
    blocks_per_slot, max_seq_len)`` positions), from
    ``numpy.random.default_rng(0)`` as the reference draws them."""
    import numpy as np

    B, H, KV, D = slots, num_heads, num_kv_heads, head_dim
    G = H // KV
    pages = num_blocks + 1                                 # + trash block
    rng = np.random.default_rng(0)
    fl = lambda a: torch.tensor(a, dtype=dtype, device=device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    q1 = fl(rng.standard_normal((B, 1, H, D)))
    kp = fl(rng.standard_normal((pages, page, KV, D)))
    vp = fl(rng.standard_normal((pages, page, KV, D)))
    tables = i32(np.arange(B * blocks_per_slot, dtype=np.int32).reshape(
        B, blocks_per_slot) % num_blocks)
    lengths = i32(np.full((B,), min(page * blocks_per_slot, max_seq_len)))
    C = min(chunk, max_seq_len)
    qc = fl(rng.standard_normal((B, C, H, D)))
    decode = dict(q=q1[:, 0].reshape(B, KV, G, D).contiguous(), k_pages=kp,
                  v_pages=vp, block_tables=tables, lengths=lengths,
                  window=None, softcap=None)
    prefill = dict(q=qc.reshape(B, C, KV, G, D).transpose(1, 2).reshape(
        B, KV, C * G, D).contiguous(), k_pages=kp, v_pages=vp,
        block_tables=tables, start_pos=i32(np.zeros(B, np.int32)),
        q_lens=i32(np.full((B,), C)), group=G, window=None, softcap=None)
    return {"paged_attention": decode, "paged_prefill": prefill}


def profile_paged_kernels(engine, reps: int = 3,
                          chunk: int = 8) -> Dict[str, Dict[str, object]]:
    """Profile the paged decode and prefill kernels at the engine's own
    serving shapes on synthetic operands in the engine's KV and query
    dtype (:func:`paged_profile_cases`), as the reference profiles
    ``paged_decode_attention`` and ``paged_prefill_attention``.  On the
    card bf16, the main path's, takes the routes the engine's rounds
    take (the decode kernel's bf16 instantiation, the tensor-core
    prefill kernel).  Requires a paged engine."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp

    cases = paged_profile_cases(**profile_shapes(engine), chunk=chunk)
    dc, pc = cases["paged_attention"], cases["paged_prefill"]
    d_bytes, d_flops = decode_cost(dc)
    p_bytes, p_flops = prefill_cost(pc)
    return {
        "paged_attention": profile_kernel(
            pa.paged_attention, dc["q"], dc["k_pages"], dc["v_pages"],
            dc["block_tables"], dc["lengths"], name="paged_attention",
            flops=d_flops, bytes_accessed=d_bytes, reps=reps),
        "paged_prefill": profile_kernel(
            pp.paged_prefill, pc["q"], pc["k_pages"], pc["v_pages"],
            pc["block_tables"], pc["start_pos"], pc["q_lens"],
            group=pc["group"], name="paged_prefill", flops=p_flops,
            bytes_accessed=p_bytes, reps=reps),
    }


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
