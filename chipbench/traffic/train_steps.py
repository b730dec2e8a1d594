"""Training steps through the launcher's own step.

The step is the one ``repro_torch.launch.train`` builds: inside
``hvd.init`` (NCCL at world size 1 on the card), the host mesh of
``launch.mesh.make_host_mesh``, ``stepfn.shard_state`` and
``stepfn.make_train_step`` under ``configs.default_strategy`` (the
launcher's choice where no ``--strategy`` is given), AdamW with
clipping by the global norm, f32 masters drawn from the seed.

The batches are a copy of the launcher's synthetic source: a noisy
first-order Markov chain over the vocabulary (each token follows a fixed
random permutation of the one before, or with probability ``noise`` is
uniform), here drawn from the seed, every row of every step its own, for
``checked_steps`` steps and a pool of ``pool_steps`` more.  Each batch is
made before the window and handed to the step as the launcher hands it (a
dict of numpy ``tokens`` and ``labels``); the loss is read after every
step, as the launcher reads it.

Set-up builds the step and its state once and drives it through the
``checked_steps`` first steps on their batches: those steps build the
kernels, and the program's readings are taken from them (each step's
loss; after step 1 every leaf's norm of AdamW's first moment over
(1 - b1), the first gradient as the optimizer got it; after the last,
every leaf's norm of the change of the weights).  The same objects then
step on in the window: ``train_tokens_per_s`` is the tokens of every step
completed in the window over the time from the first step's start to the
synchronise after the last.

The check (``correct``), once the window has closed and the program's
state is freed: the reference steps the same starting weights on the same
batches (``reference.train.readings``), and the numbers of
``reference.train.compare`` that ``check`` gives a limit are compared
with it: the median and the worst leaf's gap of the first gradient's
norm and the worst leaf's gap of the weights' change's norm, over the
leaves whose reference gradient is at least a thousandth of the median
leaf's.  The largest relative gap of a step's loss is printed beside
them (no control or fault reads far enough above it to bound it).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from chipbench import costs, weights


def markov_batches(vocab: int, batch: int, seq: int, steps: int, seed: int,
                   noise: float) -> np.ndarray:
    """(steps, batch, seq) int32 tokens of the noisy Markov chain."""
    rng = np.random.default_rng([weights.seed_of(seed), 3])
    table = rng.permutation(vocab)
    n = steps * batch
    toks = np.empty((n, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, n)
    for t in range(1, seq):
        jump = rng.random(n) < noise
        toks[:, t] = np.where(jump, rng.integers(0, vocab, n),
                              table[toks[:, t - 1]])
    return toks.astype(np.int32).reshape(steps, batch, seq)


def opt_settings(spec: Dict) -> Dict:
    o = spec["optimizer"]
    return {"lr": o["lr"], "b1": o["b1"], "b2": o["b2"], "eps": o["eps"],
            "weight_decay": o["weight_decay"], "clip_norm": o["clip_norm"]}


def leaf_norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {p: float(t.float().norm()) * scale
            for p, t in weights.leaves(tree)}


def run(cell) -> Dict:
    import torch
    from repro_torch import optim
    from repro_torch.configs import default_strategy
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    from chipbench import devtrace
    from chipbench.reference import train as ref

    spec, cfg, seed = cell.spec, cell.port_cfg, cell.seed
    B, S = spec["global_batch"], spec["seq_len"]
    n_check = spec["checked_steps"]
    o = opt_settings(spec)
    clock = time.perf_counter
    with hvd.init(cell.device) as dev:
        cuda = dev.type == "cuda"
        groups = make_host_mesh()
        layout = weights.port_layout(cfg, torch.float32)
        params = weights.draw(layout, weights.seed_of(seed), dev)
        t_begin = clock()
        opt = optim.adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"],
                          clip_norm=o["clip_norm"])
        strategy = default_strategy(cfg)
        params, state = stepfn.shard_state(params, cfg, opt, strategy,
                                           groups)
        step_fn = stepfn.make_train_step(cfg, opt, groups, strategy=strategy,
                                         device=dev)
        toks = markov_batches(cfg.vocab_size, B, S,
                              n_check + spec["pool_steps"],
                              seed, spec["noise"])
        checked, pool = toks[:n_check], toks[n_check:]

        losses: List[float] = []
        for i, b in enumerate(checked):
            params, state, m = step_fn(params, state,
                                       {"tokens": b, "labels": b})
            losses.append(float(m["loss"]))
            if i == 0:
                grads = leaf_norms(state["mu"], 1.0 / (1.0 - o["b1"]))
        now_w = dict(weights.leaves(params))
        with torch.no_grad():
            change = {p: float((now_w[p].float() - t0.float()).norm())
                      for p, t0 in weights.draw_each(
                          layout, weights.seed_of(seed), dev)}
        del now_w

        cell.note(f"set-up: the checked steps, kernels built in the first, "
                  f"and the change's norms {clock() - t_begin:.3f} s after "
                  f"the weights were drawn")
        trace = None
        if cell.trace:
            devtrace.warm()
            trace = devtrace.Slice()
        # the traced slice sits in the middle of the window; the seconds
        # the profiler takes to stop and collect are left out of it
        trace_from = max(0.0, (cell.seconds - spec["trace_seconds"]) / 2)
        trace_on = None
        stop_s = 0.0
        traced_steps = 0
        span = torch.profiler.record_function
        if cuda:
            torch.cuda.synchronize(dev)
        setup_end = time.time()
        t_first = clock()
        steps = 0
        while True:
            now = clock() - t_first - stop_s
            if trace is not None and trace_on is None and now >= trace_from:
                trace.start()
                trace_on = now
            elif trace_on is not None and trace._prof is not None and \
                    now - trace_on >= spec["trace_seconds"]:
                t_stop = clock()
                trace.stop()
                stop_s = clock() - t_stop
            tracing = trace is not None and trace._prof is not None
            with span("bench.step"):
                with span("bench.handoff"):
                    b = pool[steps % len(pool)]
                    batch = {"tokens": b, "labels": b}
                with span("bench.step_call"):
                    params, state, m = step_fn(params, state, batch)
                with span("bench.loss_read"):
                    float(m["loss"])
            steps += 1
            traced_steps += tracing
            if clock() - t_first - stop_s >= cell.seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = clock() - t_first - stop_s
        if trace is not None and trace._prof is not None:
            trace.stop()
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        del params, state, step_fn, m
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        flops = costs.ModelFlops(cell.config)
        cell.note(f"window {window_s:.3f} s, {steps} steps of {B} x {S} "
                  f"tokens; checked steps' losses {losses}")
        layer_ctx = {"window_s": window_s,
                     "train_flops": flops.train_step(B, S) * steps}
        if trace is not None:
            nb, fl = costs.flash_fwd_cost(B, S, S, cfg.num_heads,
                                          cfg.num_kv_heads,
                                          cfg.resolved_head_dim)
            calls, ns = trace.kernel_ns("flash_fwd_tc_kernel")
            layer_ctx["trace"] = {"busy_s": trace.busy_s(),
                                  "window_s": trace.window_s,
                                  "flash_fwd": (calls, ns),
                                  "flash_fwd_bound_s":
                                      calls * costs.bound_s(nb, fl)}
            cell.note(f"traced {trace.window_s:.3f} s over {traced_steps} "
                      f"steps, {len(trace.kernels)} device operations, "
                      f"{calls} flash forwards")

        # --- the check: the reference from the same start -------------
        start = weights.draw(layout, weights.seed_of(seed), dev)
        r = ref.readings(start, cell.config, checked, o,
                         rows=spec["check"]["rows"])
        del start
        got = ref.compare({"losses": losses, "grad_norms": grads,
                           "change_norms": change}, r)
        lim = spec["check"]
        checks = {k: {"value": got[k], "limit": lim[k]}
                  for k in got if k in lim}
        cell.note(f"reference losses {r['losses']}; loss gap "
                  f"{got['loss_gap']!r}; {got['leaves']} of "
                  f"{len(r['grad_norms'])} leaves compared; the worst "
                  f"leaf's first-gradient gap {got['grad_gap_worst']!r}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    tokens = steps * B * S
    return {"correct": correct, "attempted": steps, "failed": 0,
            "e2e": {"train_tokens_per_s": tokens / window_s},
            "setup_end": setup_end, "layer_ctx": layer_ctx,
            "memory_peak_bytes": memory_peak,
            "breakdown": trace.breakdown() if trace is not None else None,
            "checks": checks}
