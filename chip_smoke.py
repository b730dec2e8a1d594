#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. device   — the card's name, device count, and ``nvidia-smi``'s name and
              power limit;
2. build    — nvcc builds every CUDA kernel from ``src/repro_torch/kernels/
              csrc`` into the git-ignored ``build/`` (ptxas report printed);
3. kernels  — each kernel against its plain PyTorch version on CUDA tensors
              at qwen2-0.5b shapes (KV 2, G 7, D 64, page 16) and gemma2-2b
              shapes (KV 4, G 2, D 288, window 4096 with longer contexts,
              softcap 50), with ragged lengths, trash/garbage table entries
              and q_len == 0 rows;
4. times    — each kernel at the main path's shapes (decode: B = 8,
              contexts 512-2048; prefill: B = 4, C = 64) with CUDA events,
              L2 flushed before every launch, beside its plain version, the
              library yardstick (gather + scaled_dot_product_attention,
              used nowhere in the port) and its bound (bytes at 3.35 TB/s or
              flops at 989 TFLOP/s, whichever is larger);
5. serving  — full-width qwen2-0.5b (random weights, seed 0): (a) the port's
              launcher ``repro_torch.launch.serve.main``; (b) the scheduler
              and engine driven directly with 12 prompts of 320-1024 tokens
              sharing a 256-token prefix.  Both kernels' launch counters are
              zeroed just before each part and must be > 0 after it; every
              request completes, the prefix cache hits, nothing leaks;
6. card vs CPU — the same weights on the CPU (plain kernel versions): one
              48-token prompt, last-position logits within tolerance and 4
              equal greedy tokens.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero before
printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
KERNEL_TOL = 2e-2              # bf16 output: one bf16 ulp at |x| ~ 4, plus
                               # f32 summation order; outputs are convex
                               # mixes of N(0, 1) values
CPU_LOGIT_TOL = 5e-2           # 24 layers of bf16 GEMMs summed in another
                               # order (cuBLAS vs CPU), logits of std ~0.6


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# kernel inputs, plain versions, library yardsticks
# ---------------------------------------------------------------------------

def decode_case(torch, rng, dev, *, B, KV, G, D, page, lengths, window=None,
                softcap=None, garbage=True):
    """Random decode inputs with ragged ``lengths``; each row owns its own
    pages; entries past a row's extent name the trash page (the last) or,
    with ``garbage``, out-of-range ids the kernel must clamp and mask."""
    pps = max(1, -(-max(lengths) // page))
    NP = B * pps + 1
    tables = rng.permutation(NP - 1)[:B * pps].reshape(B, pps)
    for b, n in enumerate(lengths):
        used = -(-n // page)
        tables[b, used:] = NP - 1
        if garbage and used < pps:
            tables[b, pps - 1] = NP + 5 + b          # clamped, masked
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                                 device=dev)
    return dict(q=mk(B, KV, G, D), k_pages=mk(NP, page, KV, D),
                v_pages=mk(NP, page, KV, D),
                block_tables=torch.tensor(tables, dtype=torch.int32,
                                          device=dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
                window=window, softcap=softcap)


def prefill_case(torch, rng, dev, *, B, KV, G, D, page, C, starts, q_lens,
                 window=None, softcap=None):
    ends = [s + C for s in starts]
    case = decode_case(torch, rng, dev, B=B, KV=KV, G=G, D=D, page=page,
                       lengths=ends, window=window, softcap=softcap)
    case["q"] = torch.tensor(rng.standard_normal((B, KV, C * G, D)),
                             dtype=torch.bfloat16, device=dev)
    case.pop("lengths")
    case["start_pos"] = torch.tensor(starts, dtype=torch.int32, device=dev)
    case["q_lens"] = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    case["group"] = G
    return case


def gather_dense(torch, pages, tables):
    NP, page, KV, D = pages.shape
    B, pps = tables.shape
    idx = tables.long().clamp(0, NP - 1).reshape(-1)
    return pages.index_select(0, idx).reshape(B, pps * page, KV, D)


def library_decode(torch, F, case):
    """One library call for the same function: gather the pages dense,
    then scaled_dot_product_attention with a length/window mask (no
    softcap support there, so it is timed only where softcap is None)."""
    q, tables, lengths = case["q"], case["block_tables"], case["lengths"]
    B, KV, G, D = q.shape
    k = gather_dense(torch, case["k_pages"], tables).permute(0, 2, 1, 3)
    v = gather_dense(torch, case["v_pages"], tables).permute(0, 2, 1, 3)
    T = k.shape[2]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if case["window"]:
        mask &= (lengths[:, None] - 1 - kpos) < case["window"]
    out = F.scaled_dot_product_attention(
        q.reshape(B, KV * G, 1, D), k, v, attn_mask=mask[:, None, None, :],
        enable_gqa=True)
    return out.reshape(B, KV, G, D)


def library_prefill(torch, F, case):
    q, tables = case["q"], case["block_tables"]
    B, KV, CG, D = q.shape
    G = case["group"]
    C = CG // G
    k = gather_dense(torch, case["k_pages"], tables).permute(0, 2, 1, 3)
    v = gather_dense(torch, case["v_pages"], tables).permute(0, 2, 1, 3)
    T = k.shape[2]
    qh = q.reshape(B, KV, C, G, D).permute(0, 1, 3, 2, 4).reshape(
        B, KV * G, C, D)
    qpos = case["start_pos"][:, None] + torch.arange(C, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if case["window"]:
        mask &= (qpos[:, :, None] - kpos[None, None, :]) < case["window"]
    out = F.scaled_dot_product_attention(qh, k, v, attn_mask=mask[:, None],
                                         enable_gqa=True)
    return out.reshape(B, KV, G, C, D).permute(0, 1, 3, 2, 4).reshape(
        B, KV, CG, D)


def decode_cost(case):
    """(bytes, flops) the function needs for these inputs: q, the K and V
    positions each row attends (window included), out; 4 flops per
    (query head, position, dim)."""
    B, KV, G, D = case["q"].shape
    lens = case["lengths"].tolist()
    w = case["window"]
    pos = sum(min(n, w) if w else n for n in lens)
    q_bytes = B * KV * G * D * 2
    nbytes = 2 * q_bytes + pos * KV * D * 2 * 2 + B * 4 * (
        1 + case["block_tables"].shape[1])
    return nbytes, 4 * pos * KV * G * D


def prefill_cost(case):
    B, KV, CG, D = case["q"].shape
    G = case["group"]
    starts, qls = case["start_pos"].tolist(), case["q_lens"].tolist()
    w = case["window"]
    hist = attended = 0
    for s, ql in zip(starts, qls):
        if ql == 0:
            continue
        lo = max(0, s - w + 1) if w else 0
        hist += s + ql - lo                      # positions read
        for c in range(ql):
            p = s + c
            attended += p + 1 - (max(0, p - w + 1) if w else 0)
    q_bytes = B * KV * CG * D * 2
    nbytes = 2 * q_bytes + hist * KV * D * 2 * 2 + B * 4 * (
        2 + case["block_tables"].shape[1])
    return nbytes, 4 * attended * KV * G * D


def time_ms(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after the L2 cache is flushed (a 128 MB write)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------

def check_no_leaks(sched, label: str) -> None:
    eng = sched.engine
    kv = eng.kv
    check(not sched.queue and not sched.active and not sched.prefilling,
          f"{label}: work left in the scheduler")
    check(kv.free_slot_count == kv.max_slots,
          f"{label}: {kv.max_slots - kv.free_slot_count} slot(s) leaked")
    check(kv.pool.in_use == 0, f"{label}: {kv.pool.in_use} block(s) leaked")
    pc = eng.prefix_cache
    if pc is not None:
        # with every request retired, evicting the whole tree must return
        # every prefix block: a block still held is a leaked pin
        pc.evict(kv.prefix_pool.num_blocks)
        check(kv.prefix_pool.in_use == 0,
              f"{label}: {kv.prefix_pool.in_use} prefix pin(s) leaked")


def report_serving(torch, sched, label: str, dev) -> dict:
    s = sched.metrics.summary()
    out = {"requests": s["requests_completed"],
           "new_tokens": s["total_new_tokens"],
           "tokens_per_s": s["tokens_per_s"],
           "ttft_ms_p50": s["ttft_ms"]["p50"],
           "ttft_ms_p95": s["ttft_ms"]["p95"],
           "decode_gap_ms_p50": s["decode_gap_ms"]["p50"],
           "decode_gap_ms_p95": s["decode_gap_ms"]["p95"],
           "prefix_hit_rate": s["prefix_cache"]["hit_rate"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    if sched.profiler is not None:
        out["decode_step_ms_p50"] = \
            sched.profiler.summary()["decode_ms"]["p50"]
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device ------------------------------------------------------------
    phase("device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = (smi.stdout.strip().splitlines() or ["unavailable"])[0]
    print(f"device: {name}; device_count {count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi_line, flush=True)

    # 2. build -------------------------------------------------------------
    phase("build")
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc wall {_build.build_seconds})")
    for src, log in sorted(_build.ptxas_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")
    sys.stdout.flush()

    # 3. kernel vs plain ----------------------------------------------------
    phase("kernels vs plain")
    rng = np.random.default_rng(0)
    shape_sets = {
        "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None,
                           softcap=None, lengths=[1, 17, 300, 0, 512, 33],
                           starts=[0, 40, 129, 300], C=16,
                           q_lens=[16, 9, 0, 1]),
        "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=4096,
                          softcap=50.0, lengths=[4097, 5000, 100, 0],
                          starts=[4090, 4500, 0, 4200], C=16,
                          q_lens=[16, 5, 16, 0]),
    }
    worst = {}
    for label, s in shape_sets.items():
        dc = decode_case(torch, rng, dev, B=len(s["lengths"]), KV=s["KV"],
                         G=s["G"], D=s["D"], page=s["page"],
                         lengths=s["lengths"], window=s["window"],
                         softcap=s["softcap"])
        got = pa.paged_attention(dc["q"], dc["k_pages"], dc["v_pages"],
                                 dc["block_tables"], dc["lengths"],
                                 window=dc["window"], softcap=dc["softcap"])
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(
            dc["q"], dc["k_pages"], dc["v_pages"], dc["block_tables"],
            dc["lengths"], window=dc["window"], softcap=dc["softcap"])
        err = (got.float() - ref.float()).abs().max().item()
        zero_ok = bool((got[3] == 0).all()) if 0 in s["lengths"] else True
        print(f"decode  {label}: max_abs_err {err:.3e} (tol {KERNEL_TOL}); "
              f"length-0 row zeros: {zero_ok}")
        check(err <= KERNEL_TOL and zero_ok,
              f"decode kernel disagrees at {label} shapes")
        worst["paged_decode_attention"] = max(
            worst.get("paged_decode_attention", 0.0), err)

        pc_ = prefill_case(torch, rng, dev, B=len(s["starts"]), KV=s["KV"],
                           G=s["G"], D=s["D"], page=s["page"], C=s["C"],
                           starts=s["starts"], q_lens=s["q_lens"],
                           window=s["window"], softcap=s["softcap"])
        args = (pc_["q"], pc_["k_pages"], pc_["v_pages"],
                pc_["block_tables"], pc_["start_pos"], pc_["q_lens"])
        kw = dict(group=pc_["group"], window=pc_["window"],
                  softcap=pc_["softcap"])
        got = pp.paged_prefill(*args, **kw)
        torch.cuda.synchronize()
        ref = pp.paged_prefill_plain(*args, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"prefill {label}: max_abs_err {err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"prefill kernel disagrees at {label}")
        worst["paged_prefill_attention"] = max(
            worst.get("paged_prefill_attention", 0.0), err)
    sys.stdout.flush()

    # 4. times at the main path's shapes -----------------------------------
    phase("times")
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    dcase = decode_case(torch, rng, dev, B=8, KV=2, G=7, D=64, page=16,
                        lengths=[512, 704, 896, 1088, 1280, 1472, 1664, 2048],
                        garbage=False)
    pcase = prefill_case(torch, rng, dev, B=4, KV=2, G=7, D=64, page=16,
                         C=64, starts=[0, 256, 640, 1024],
                         q_lens=[64, 64, 64, 64])
    dargs = (dcase["q"], dcase["k_pages"], dcase["v_pages"],
             dcase["block_tables"], dcase["lengths"])
    pargs = (pcase["q"], pcase["k_pages"], pcase["v_pages"],
             pcase["block_tables"], pcase["start_pos"], pcase["q_lens"])
    pkw = dict(group=pcase["group"])
    kernels = []
    for kname, fn, plain, lib, cost, case, src, tpu in (
            ("paged_decode_attention",
             lambda: pa.paged_attention(*dargs),
             lambda: pa.paged_attention_plain(*dargs),
             lambda: library_decode(torch, F, dcase), decode_cost, dcase,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:97"),
            ("paged_prefill_attention",
             lambda: pp.paged_prefill(*pargs, **pkw),
             lambda: pp.paged_prefill_plain(*pargs, **pkw),
             lambda: library_prefill(torch, F, pcase), prefill_cost, pcase,
             "src/repro_torch/kernels/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:111")):
        err = (fn().float() - plain().float()).abs().max().item()
        lib_err = (lib().float() - plain().float()).abs().max().item()
        check(err <= KERNEL_TOL, f"{kname} disagrees at timing shapes")
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        lib_ms = time_ms(torch, lib, flush)
        nbytes, flops = cost(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / BF16_FLOPS_PER_S * 1e3
        bound_by = "bytes" if t_bytes >= t_flops else "operations"
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": tpu, "tpu_kernel": tpu, "launches": 0,
                 "max_abs_err": max(err, worst[kname]),
                 "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_flops), "bound_by": bound_by,
                 "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
        kernels.append(entry)
        print(f"{kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms (gather + SDPA, err vs plain "
              f"{lib_err:.2e}), bound {entry['bound_ms']:.4f} ms by "
              f"{bound_by} ({nbytes} B, {flops} flop)", flush=True)

    # 5. serving at full width ---------------------------------------------
    phase("serving qwen2-0.5b, full width")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg = get_config("qwen2-0.5b")
    torch.cuda.reset_peak_memory_stats(dev)
    pa.paged_attention.launches = 0
    pp.paged_prefill.launches = 0
    sched_a = launcher.main([
        "--arch", "qwen2-0.5b", "--paged", "--max-slots", "8",
        "--max-seq-len", "2048", "--prefill-batch", "4",
        "--prefill-token-budget", "512", "--prefix-cache-blocks", "256",
        "--shared-prefix", "256", "--requests", "12", "--max-new", "32",
        "--greedy", "--metrics-json", str(OUT / "serve_metrics.json")])
    torch.cuda.synchronize()
    launches_a = {"paged_decode_attention": pa.paged_attention.launches,
                  "paged_prefill_attention": pp.paged_prefill.launches}
    print(f"(a) launcher: kernel launches {launches_a}")
    rep_a = report_serving(torch, sched_a, "(a) launcher", dev)
    check(rep_a["requests"] == 12, "(a) not every request completed")
    check(all(v > 0 for v in launches_a.values()),
          "(a) a kernel of the path was never launched")
    check(rep_a["prefix_hit_rate"] > 0, "(a) no prefix-cache hit")
    check_no_leaks(sched_a, "(a)")
    params = sched_a.engine.params
    del sched_a
    torch.cuda.empty_cache()

    rs = np.random.default_rng(1)
    shared = rs.integers(0, cfg.vocab_size, 256, dtype=np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, int(rs.integers(64, 769)), dtype=np.int32)])
        for _ in range(12)]
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, max_seq_len=2048, max_slots=8,
                        prefix_cache_blocks=256, paged=True,
                        prefill_batch=4, device=dev)
    sched_b = Scheduler(eng, prefill_token_budget=512, profile=True)
    pa.paged_attention.launches = 0
    pp.paged_prefill.launches = 0
    rids = [sched_b.submit(Request(p, SamplingParams(max_new_tokens=32,
                                                     greedy=True)))
            for p in prompts]
    sched_b.run()
    torch.cuda.synchronize()
    launches_b = {"paged_decode_attention": pa.paged_attention.launches,
                  "paged_prefill_attention": pp.paged_prefill.launches}
    print(f"(b) long prompts {[len(p) for p in prompts]}: kernel launches "
          f"{launches_b}")
    rep_b = report_serving(torch, sched_b, "(b) direct", dev)
    outs = [sched_b.output(r) for r in rids]
    check(all(len(o) == 32 for o in outs), "(b) not every request completed")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
          "(b) token ids out of range")
    check(all(v > 0 for v in launches_b.values()),
          "(b) a kernel of the path was never launched")
    check(rep_b["prefix_hit_rate"] > 0, "(b) no prefix-cache hit")
    check_no_leaks(sched_b, "(b)")
    for k in kernels:
        k["launches"] = launches_a[k["name"]] + launches_b[k["name"]]
        k["launches_per_part"] = [launches_a[k["name"]],
                                  launches_b[k["name"]]]
    del sched_b, eng
    torch.cuda.empty_cache()

    # where a decode step's time goes: one full-width decode_step at the
    # kernel-timing shapes (B = 8, contexts 512-2048, random KV), timed
    # like the kernels, against its 24 decode-kernel launches
    from repro_torch.models import transformer as T
    shape = (cfg.num_layers, 1, dcase["k_pages"].shape[0], 16,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    step_batch = {
        "tokens": torch.zeros((8, 1), dtype=torch.int32, device=dev),
        "positions": dcase["lengths"] - 1,
        "cache": {"layers": {n: torch.randn(shape, dtype=torch.bfloat16,
                                            device=dev) for n in "kv"}},
        "block_tables": dcase["block_tables"]}
    step_ms = time_ms(torch, lambda: T.decode_step(params, cfg, step_batch),
                      flush, reps=10)
    attn_ms = cfg.num_layers * kernels[0]["ms"]
    print(f"decode step, B=8, contexts 512-2048, full width: {step_ms:.3f} "
          f"ms; {cfg.num_layers} decode-kernel launches {attn_ms:.3f} ms "
          f"({attn_ms / step_ms:.1%})", flush=True)
    del step_batch, flush
    torch.cuda.empty_cache()

    # 6. card vs CPU --------------------------------------------------------
    phase("card vs CPU")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 48,
                                               dtype=np.int32)
    results = {}
    for where in ("cuda", "cpu"):
        # the engine copies the weights to its device
        e = ServingEngine(cfg, params, max_seq_len=64, max_slots=1,
                          paged=True, prefill_batch=1,
                          device=dev if where == "cuda" else "cpu")
        slot, last = e.prefill_into_slot(prompt)
        e.free_slot(slot)
        toks = e.generate([Request(prompt, SamplingParams(
            max_new_tokens=4, greedy=True))])[0]
        results[where] = (last, toks)
    (lg, tg), (lc, tc) = results["cuda"], results["cpu"]
    check(np.isfinite(lg).all() and lg.shape == (cfg.vocab_size,),
          "card logits not finite or of the wrong shape")
    diff = float(np.abs(lg - lc).max())
    print(f"last-position logits: max |cuda - cpu| {diff:.3e} (tol "
          f"{CPU_LOGIT_TOL}, logit std {float(lc.std()):.3f}); greedy "
          f"cuda {tg.tolist()} cpu {tc.tolist()}")
    check(diff <= CPU_LOGIT_TOL, "card and CPU logits disagree")
    check(tg.tolist() == tc.tolist(), "card and CPU greedy tokens differ")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
