#!/usr/bin/env python3
"""Where one full-width training step of the PyTorch port spends the card.

    python scripts/torch_step_profile.py [--src DIR] [--arch qwen2-0.5b]
                                         [--batch 8] [--ranges]

Two unprofiled steps, then one under ``torch.profiler`` (seq 1024,
``--batch`` rows, AdamW over f32 masters, the launcher's ``dp`` step at
world size 1 with its gradient all_reduce:
``chip_smoke.profiled_train_step``); prints the card's name and power
limit, then one JSON line with the device time by kernel family
(``chip_smoke.profile_breakdown``).
``--src`` names the ``src`` directory whose ``repro_torch`` runs
(default: this checkout's), so that two trees compare on one card: unpack
the other with ``git archive`` into a git-ignored directory and run them
in the order a, b, b, a.  Its ``stepfn.make_train_step`` must take the
data group (``make_train_step(cfg, optimizer, groups, ...)``), as this
checkout's does.

``--ranges`` wraps, from this script and whatever the tree, the tied
unembedding (``modules.unembed``) and the flash backward
(``flash_attention.flash_attention_bwd``) in profiler ranges:
``unembed.fwd`` around the call, ``unembed.bwd`` from the moment its
logits' gradient arrives to the moment x's gradient leaves (pass-through
autograd functions on either side), ``flash.bwd`` around each backward
call.  The line then holds, under ``"ranges"``, each range's kernel time
by kernel class (``f32_gemm``: ``*f32f32*`` GEMMs on the CUDA cores;
``cutlass_kernel2``; ``elementwise``; ``bf16_gemm``; ``other``) and its
largest kernels, with the whole step's classes beside them.  It is
there to re-measure how the step's time splits between the unembedding,
the flash backward and the elementwise tail (ROADMAP.md Queue 4, T2 and
T3), and needs nothing of the tree it profiles.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANGES = ("unembed.fwd", "unembed.bwd", "flash.bwd")


def kernel_class(name: str) -> str:
    if "f32f32" in name:
        return "f32_gemm"
    if "cutlass::Kernel2" in name:
        return "cutlass_kernel2"
    if "elementwise" in name:
        return "elementwise"
    if "nvjet" in name or "bf16" in name:
        return "bf16_gemm"
    return "other"


def install_ranges(torch) -> None:
    """Wrap the unembedding and the flash backward in the profiler ranges
    of :data:`RANGES` (module attributes, looked up at each call)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import modules
    record = torch.autograd.profiler.record_function

    class Open(torch.autograd.Function):
        """Identity on the logits; its backward opens ``unembed.bwd``."""
        @staticmethod
        def forward(ctx, y, box):
            ctx.box = box
            return y.view_as(y)

        @staticmethod
        def backward(ctx, g):
            ctx.box.append(record("unembed.bwd"))
            ctx.box[-1].__enter__()
            return g, None

    class Close(torch.autograd.Function):
        """Identity on x; its backward closes ``unembed.bwd``."""
        @staticmethod
        def forward(ctx, x, box):
            ctx.box = box
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if ctx.box:
                ctx.box.pop().__exit__(None, None, None)
            return g, None

    unembed, bwd = modules.unembed, fa.flash_attention_bwd

    def ranged_unembed(p, x, sh=None):
        box = []
        with record("unembed.fwd"):
            y = unembed(p, Close.apply(x, box), sh)
        return Open.apply(y, box)

    def ranged_bwd(*a, **kw):
        with record("flash.bwd"):
            return bwd(*a, **kw)

    modules.unembed = ranged_unembed
    fa.flash_attention_bwd = ranged_bwd


def read_ranges(prof) -> dict:
    """Kernel ms by class under each range of :data:`RANGES` (every
    kernel launched from an op nested in it) and over the whole step."""
    def kernels(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from kernels(c)

    out = {name: {"calls": 0, "by_class_ms": defaultdict(float),
                  "by_kernel_ms": defaultdict(float)} for name in RANGES}
    for e in prof.events():
        if e.name not in out or getattr(e, "is_user_annotation", False) \
                and str(e.device_type).endswith("CUDA"):
            continue                  # the range's copy on the device
        r = out[e.name]
        r["calls"] += 1
        for k in kernels(e):
            r["by_class_ms"][kernel_class(k.name)] += k.duration / 1e3
            r["by_kernel_ms"][k.name[:90]] += k.duration / 1e3
    step = defaultdict(float)
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and e.key not in ranges:
            step[kernel_class(e.key)] += e.self_device_time_total / 1e3
    for r in out.values():
        top = sorted(r["by_kernel_ms"].items(), key=lambda kv: -kv[1])
        r["by_kernel_ms"] = dict(top[:8])
        r["by_class_ms"] = dict(r["by_class_ms"])
    return {"ranges": out, "step_by_class_ms": dict(step)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ranges", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    if args.ranges:
        install_ranges(torch)
    prof, wall_ms = chip_smoke.profiled_train_step(
        torch, get_config(args.arch), torch.device("cuda"), args.batch)
    out = chip_smoke.profile_breakdown(prof, wall_ms)
    if args.ranges:
        out.update(read_ranges(prof))
    print(json.dumps({"src": str(src), "arch": args.arch,
                      "batch": args.batch, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
