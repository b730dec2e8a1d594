"""Closed-loop serving: a fixed number of clients, each sending its next
request the moment its last one returned, through the port's gateway.

The traffic mix is the workload file's parameters: ``clients``;
``prompt_len`` and ``output_len`` as log-normal (``median``, ``sigma``)
clipped to [``min``, ``max``]; ``block``; ``first_horizon``; the engine's
settings under ``engine`` (those ``launch/serve.py`` takes: ``paged``,
``max_slots``, ``max_seq_len``, ``prefill_batch``,
``prefill_token_budget``); the check under ``check``.

Every seed serves the same sizes in an order of its own: requests come
in blocks of ``block``, each holding the log-normals' quantiles at (j +
1/2) / block, prompts and outputs each permuted by the seed and the
block's index (``request_sizes``); the token ids are drawn from the seed
too.  Request i of the run is the i-th the clients send.  Decoding is
greedy and no EOS stops a request: it returns after exactly its output
length.

Warm-up: client c's first request has its output cut to the share (c +
1/2) / clients of the smaller of its drawn length and ``first_horizon``, so
that retirements spread from the start.  The window opens at the step at
which the last client's first request returned (every slot has then been
refilled once) and closes at the first step that ends ``--seconds`` later.
After it closes no request is sent, and the engine steps on until every
request due inside the window has its first token (at most 60 s).

Time stamps are taken on the host after each ``gateway.step()``, which
ends in the scheduler's read-back of the sampled tokens: a token's time is
the moment the client could see it.  The end-to-end metrics:

* ``serve_tokens_per_s``: output tokens stamped inside the window over the
  window's seconds;
* ``ttft_p90_ms``: the 90th percentile, over every request due inside the
  window (sent at or after the open, before the close), of its first
  token's time less the moment it was due (its client's previous request
  returned); a request that failed counts as missing (the wait to the
  drain's end);
* ``itl_p95_ms``: the 95th percentile of every gap between consecutive
  output tokens of a request, both inside the window.

With ``--trace 1`` this module wraps the engine's calls (admission,
prefill, decode, sampling, and the gateway step) in ``record_function``
spans and CUDA events, and profiles the last ``trace_seconds`` of the
window (``devtrace.Slice``); the layer metrics read what it recorded.

The check (``correct``): once the window has closed, a sample drawn from
the seed of the requests that finished (the one with the most output
tokens in it, ``check.requests`` in all); with the program's state freed,
the reference runs once over each prompt with its served tokens, and for
every served token it reads the gap by which the token's reference logit
lies below the reference's best at that position.  The widest of these
gaps and their mean are compared with ``check.widest_gap`` and
``check.mean_gap``; a request that failed, or whose served length is not
its output length, makes the run not correct too.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

from chipbench import costs, stats, weights

DRAIN_S = 60.0


def size_grid(p: Dict, n: int) -> np.ndarray:
    """A block's lengths: the clipped log-normal's quantiles at (i + 1/2)
    / n, i = 0 .. n - 1."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    L = np.rint(p["median"] * np.exp(p["sigma"] * z)).astype(np.int64)
    return np.clip(L, p["min"], p["max"])


def request_sizes(spec: Dict, seed: int, i: int):
    """(prompt length, output length) of the run's request i.  Requests
    come in blocks of ``spec["block"]``; every block holds the same
    lengths, the clipped log-normals' quantiles at (j + 1/2) / block, in
    an order drawn from the seed and the block's index (prompts and
    outputs each permuted), so every seed serves the same set of sizes."""
    n = spec["block"]
    b, j = divmod(i, n)
    rng = np.random.default_rng([weights.seed_of(seed), 4, b])
    p = size_grid(spec["prompt_len"], n)[rng.permutation(n)]
    o = size_grid(spec["output_len"], n)[rng.permutation(n)]
    return int(p[j]), int(o[j])


def prompt_tokens(seed: int, i: int, n: int, vocab: int) -> np.ndarray:
    """Request i's prompt: n token ids uniform over the vocabulary."""
    rng = np.random.default_rng([weights.seed_of(seed), 1, i])
    return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def first_output(spec: Dict, client: int, drawn: int) -> int:
    """Client ``client``'s first request's output: the share (c + 1/2) /
    clients of the smaller of its drawn length and ``first_horizon``."""
    share = (client + 0.5) / spec["clients"]
    return max(1, int(round(share * min(drawn, spec["first_horizon"]))))


@dataclass
class Record:
    client: int
    index: int
    prompt: np.ndarray
    out_len: int
    due: float
    state: object = None
    times: List[float] = field(default_factory=list)
    steps: List[int] = field(default_factory=list)
    done: Optional[float] = None

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None


class _Timed:
    """CUDA events around one kind of engine call, with the step it ran
    in and how many program replays it made."""

    def __init__(self):
        self.calls = []                  # (step, start, end, replays)

    def wrap(self, fn, span: str, step_of, replays_of, torch):
        def timed(*a, **k):
            before = replays_of()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(span):
                start.record()
                out = fn(*a, **k)
                end.record()
            self.calls.append((step_of(), start, end, replays_of() - before))
            return out
        return timed

    def summary(self, steps) -> Dict[str, float]:
        ms = n = 0.0
        for step, s, e, r in self.calls:
            if step in steps and r:
                ms += s.elapsed_time(e)
                n += r
        return {"ms": ms, "replays": n}


def _span(fn, name: str, torch):
    def spanned(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return spanned


def run(cell) -> Dict:
    import torch
    from repro_torch.serving import (ReplicaGateway, Request, SamplingParams,
                                     ServingEngine)
    from chipbench import devtrace

    spec, cfg, seed = cell.spec, cell.port_cfg, cell.seed
    eng_kw = spec["engine"]
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    clock = time.perf_counter
    t_begin = clock()
    layout = weights.port_layout(cfg, getattr(torch, cfg.dtype))
    params = weights.draw(layout, weights.seed_of(seed), dev)
    engine = ServingEngine(
        cfg, params, max_seq_len=eng_kw["max_seq_len"],
        max_slots=eng_kw["max_slots"], paged=eng_kw["paged"],
        prefill_batch=eng_kw["prefill_batch"],
        rng_seed=weights.seed_of(seed) % 2 ** 31, device=dev)
    t_weights = clock()
    engine.warm_up()
    t_built = clock()
    gateway = ReplicaGateway.from_engines(
        [engine], prefill_token_budget=eng_kw["prefill_token_budget"])
    sched = gateway.replicas[0].scheduler
    health = gateway.health[0]

    step_no = [0]
    prefill_t, decode_t = _Timed(), _Timed()
    if cell.trace:
        devtrace.warm()
        prog = engine.programs
        engine.advance_prefill = prefill_t.wrap(
            engine.advance_prefill, "bench.prefill", lambda: step_no[0],
            lambda: prog["prefill_paged"].replays, torch)
        engine.decode_once = decode_t.wrap(
            engine.decode_once, "bench.decode", lambda: step_no[0],
            lambda: prog["decode_step"].replays, torch)
        engine.sample_tokens = _span(engine.sample_tokens, "bench.sample",
                                     torch)
        sched._admit = _span(sched._admit, "bench.admit", torch)

    vocab = cfg.vocab_size
    records: List[Record] = []
    live: Dict[int, Record] = {}
    served = [0] * spec["clients"]

    def send(client: int, now: float) -> None:
        i = len(records)
        p_len, out = request_sizes(spec, seed, i)
        if served[client] == 0:
            out = first_output(spec, client, out)
        rec = Record(client, i, prompt_tokens(seed, i, p_len, vocab), out,
                     now)
        h = gateway.submit(Request(rec.prompt, SamplingParams(
            max_new_tokens=out, greedy=True, eos_token=None)))
        rec.state = sched.queue[-1]
        if rec.state.rid != h[1]:
            raise RuntimeError("the gateway queued another request")
        records.append(rec)
        live[client] = rec

    def observe(now: float, sending: bool) -> None:
        for client, rec in list(live.items()):
            n = len(rec.state.emitted)
            if n > len(rec.times):
                new = n - len(rec.times)
                rec.times.extend([now] * new)
                rec.steps.extend([step_no[0]] * new)
            if rec.state.finish_reason:
                rec.done = now
                served[client] += 1
                del live[client]
                if sending:
                    send(client, now)

    def step() -> None:
        step_no[0] += 1
        with torch.profiler.record_function("bench.step"):
            gateway.step()
        if health.failures:
            raise RuntimeError(f"the replica failed: {health.last_error}")

    t0 = clock()
    for c in range(spec["clients"]):
        send(c, t0)
    while min(served) == 0:
        step()
        observe(clock(), True)
    t_open, open_step = clock(), step_no[0]
    setup_end = time.time()
    cell.note(f"set-up: weights and engine {t_weights - t_begin:.3f} s, "
              f"captures {t_built - t_weights:.3f} s, warm-up traffic "
              f"{t_open - t0:.3f} s over {open_step} steps")
    counters0 = (engine.prefill_tokens, engine.prefill_tokens_executed)
    trace = devtrace.Slice() if cell.trace else None
    trace_from = t_open + max(0.0, cell.seconds - spec["trace_seconds"])
    trace_steps = set()
    while True:
        if trace is not None and not trace_steps and clock() >= trace_from:
            trace.start()
        if trace is not None and trace._prof is not None:
            trace_steps.add(step_no[0] + 1)
        step()
        now = clock()
        closing = now - t_open >= cell.seconds
        observe(now, not closing)
        if closing:
            break
    t_close, close_step = now, step_no[0]
    if trace is not None and trace._prof is not None:
        trace.stop()
    counters1 = (engine.prefill_tokens, engine.prefill_tokens_executed)
    due = [r for r in records if t_open <= r.due < t_close]
    deadline = t_close + DRAIN_S
    while any(r.first is None for r in due) and clock() < deadline:
        step()
        observe(clock(), False)
    if cuda:
        torch.cuda.synchronize()
    window_s = t_close - t_open

    # --- end-to-end ---------------------------------------------------
    inside = lambda t: t_open < t <= t_close            # noqa: E731
    tokens = sum(1 for r in records for t in r.times if inside(t))
    ttft = [((r.first if r.first is not None else deadline) - r.due) * 1e3
            for r in due]
    gaps = [(b - a) * 1e3 for r in records
            for a, b in zip(r.times, r.times[1:])
            if a >= t_open and b <= t_close]
    failed = sum(1 for r in due if r.first is None)
    e2e = {"serve_tokens_per_s": stats.rate(tokens, window_s),
           "ttft_p90_ms": stats.percentile(ttft, 90),
           "itl_p95_ms": stats.percentile(gaps, 95)}
    cell.note(f"window {window_s:.3f} s, steps {close_step - open_step}, "
              f"output tokens {tokens}")
    cell.note(f"requests due in the window {len(due)}, "
              f"{stats.beyond(ttft, 90)} beyond ttft p90; gaps {len(gaps)}, "
              f"{stats.beyond(gaps, 95)} beyond itl p95; failed {failed}")

    # --- per-layer raw readings ---------------------------------------
    window_steps = set(range(open_step + 1, close_step + 1))
    flops = costs.ModelFlops(cell.config)
    dec_flops = sum(flops.token_fwd(len(r.prompt) + j - 1)
                    for r in records for j, s in enumerate(r.steps)
                    if j and s in window_steps)
    done_in = [r for r in records
               if r.times and r.steps[0] in window_steps]
    pref_tokens = counters1[0] - counters0[0]
    ctx_sum = sum(len(r.prompt) * (len(r.prompt) + 1) / 2 for r in done_in)
    mean_ctx = ctx_sum / max(1, sum(len(r.prompt) for r in done_in))
    pre_flops = (flops.prompt_tokens_fwd(pref_tokens, mean_ctx)
                 + 2.0 * flops.unembed_params * len(done_in))
    layer_ctx = {"window_s": window_s,
                 "prefill": prefill_t.summary(window_steps) if cell.trace
                 else None,
                 "decode": decode_t.summary(window_steps) if cell.trace
                 else None,
                 "prefill_tokens": pref_tokens,
                 "prefill_executed": counters1[1] - counters0[1],
                 "prefill_flops": pre_flops, "decode_flops": dec_flops}
    if trace is not None:
        q_shape = (eng_kw["max_slots"], cfg.num_kv_heads,
                   cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
        pps = engine.kv.blocks_per_slot
        bounds = 0.0
        for s in trace_steps:
            rows = [len(r.prompt) + j for r in records
                    for j, st in enumerate(r.steps) if j and st == s]
            if rows:
                lengths = rows + [1] * (eng_kw["max_slots"] - len(rows))
                nb, fl = costs.decode_cost(q_shape, pps, lengths)
                bounds += cfg.num_layers * costs.bound_s(nb, fl)
        layer_ctx["trace"] = {"busy_s": trace.busy_s(),
                              "window_s": trace.window_s,
                              "paged_decode_bound_s": bounds,
                              "paged_decode": trace.kernel_ns(
                                  "paged_decode_split_kernel"),
                              "paged_decode_combine": trace.following_ns(
                                  "combine_kernel",
                                  "paged_decode_split_kernel")}
        cell.note(f"traced {trace.window_s:.3f} s over {len(trace_steps)} "
                  f"steps, {len(trace.kernels)} device operations")

    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # --- the check ----------------------------------------------------
    finished = [r for r in records if r.done is not None]
    rng = np.random.default_rng([weights.seed_of(seed), 2])
    longest = max(finished, key=lambda r: (r.out_len, -r.index))
    rest = [r for r in finished if r is not longest]
    k = min(len(rest), spec["check"]["requests"] - 1)
    sample = [longest] + [rest[i] for i in
                          sorted(rng.choice(len(rest), k, replace=False))]
    seqs = [(r.prompt, np.asarray(r.state.emitted, np.int64))
            for r in sample]
    del gateway, sched, engine, live
    for r in records:
        r.state = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = served_numbers(reference_logits(params, cell.config, seqs, dev),
                         [o for _, o in seqs])
    cell.note(f"checked {len(seqs)} requests, {got['tokens']} served "
              f"tokens against the reference: widest gap "
              f"{got['widest_gap']!r}, {got['off_argmax']} off its argmax")
    checks = {k: {"value": got[k], "limit": v}
              for k, v in spec["check"].items() if k != "requests"}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()) and all(
        len(o) == r.out_len for (_, o), r in zip(seqs, sample))
    return {"correct": correct, "attempted": len(due), "failed": failed,
            "e2e": e2e, "setup_end": setup_end, "layer_ctx": layer_ctx,
            "memory_peak_bytes": memory_peak,
            "breakdown": trace.breakdown() if trace is not None else None,
            "checks": checks}


def reference_logits(params, config: Dict, seqs, dev,
                     precision: str = "f32"):
    """For each (prompt, served tokens) pair of ``seqs``, the reference's
    logits (n, V) f32 at the positions that produced its n served tokens:
    one pass over every prompt with its served tokens but the last."""
    import torch
    from chipbench.reference import model as ref
    ref.no_tf32()
    with torch.no_grad():
        toks = [torch.as_tensor(np.concatenate(
            [p.astype(np.int64), o[:-1].astype(np.int64)]), device=dev)
            for p, o in seqs]
        hs = ref.hidden_ragged(params, config, toks, precision)
        return [ref.unembed(params, config, h[len(p) - 1:], precision)
                for h, (p, _) in zip(hs, seqs)]


def served_numbers(ref_logits, outs) -> Dict:
    """For each position, the gap by which the served token's reference
    logit lies below the reference's best there (0 where it is the
    argmax); over every checked token, the widest (``widest_gap``), their
    mean (``mean_gap``) and how many were off the argmax."""
    import torch
    gaps = []
    for lg, out in zip(ref_logits, outs):
        t = torch.as_tensor(out).to(lg.device).long()
        gaps.append(lg.max(dim=-1).values
                    - lg.gather(-1, t[:, None])[:, 0])
    g = torch.cat(gaps)
    return {"mean_gap": float(g.mean()), "widest_gap": float(g.max()),
            "off_argmax": int((g > 0).sum()), "tokens": int(g.numel())}
