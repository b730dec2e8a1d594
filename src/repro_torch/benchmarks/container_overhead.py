"""Paper Tables 2 & 3: throughput and memory with and without the
container (the port of ``benchmarks/container_overhead.py``'s method).

The paper measured AlexNet/ResNet-50 img/s and free system memory with and
without Charliecloud and found no measurable overhead.  The same here for
the port's capsule runtime: one 3DGAN discriminator training step (value
and gradient of ``d_loss``, RMSProp), timed over ``steps`` steps after a
warm-up step, (a) bare and (b) inside ``Deployment.run`` of the PyTorch
image (environment scrubbed, image tree hashed before and after the run),
in interleaved rounds, the minimum taken per mode.  On the card the steps
are timed with CUDA synchronisation and the peak device memory
(``torch.cuda.max_memory_allocated``) of each mode is reported too, since
Table 3 is about memory.

  PYTHONPATH=src python -m repro_torch.benchmarks.container_overhead
  PYTHONPATH=src python -m repro_torch.benchmarks.container_overhead \\
      --smoke --batch 8 --device cpu

The default is the full ``GAN3DConfig()`` at batch 64 on the card;
``--smoke`` takes the reference's cut config (``g_fc_ch=6, g_base=16,
d_base=8``).  Rows go to stdout as CSV and to
``BENCH_torch_container_overhead.json``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.core import deploy as D
from repro_torch.data import CalorimeterSpec, generate_batch
from repro_torch.distributed.stepfn import value_and_grad
from repro_torch.models import gan3d as G

CUT_CONFIG = G.GAN3DConfig(g_fc_ch=6, g_base=16, d_base=8)


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train(steps: int, batch_size: int, cfg: G.GAN3DConfig,
           device: str) -> dict:
    """``steps`` D steps after one warm-up step; seconds per step, images/s,
    the process's RSS and, on a card, the step's peak device memory."""
    from repro_torch.serving.engine import resolve_device
    dev = resolve_device(device)
    gp = G.init_generator(cfg, torch.Generator().manual_seed(0), dev)
    dp = G.init_discriminator(cfg, torch.Generator().manual_seed(1), dev)
    d_opt = optim.rmsprop(1e-3)
    ds = d_opt.init(dp)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             generate_batch(CalorimeterSpec(), batch_size).items()}
    z = torch.randn(batch_size, cfg.latent_dim,
                    generator=torch.Generator().manual_seed(2)).to(dev)

    def step(dp, ds):
        _, _, grads = value_and_grad(
            lambda p, b: G.d_loss(p, gp, cfg, b, z), dp, batch)
        upd, ds = d_opt.update(grads, ds, dp)
        return optim.apply_updates(dp, upd), ds

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dp, ds = step(dp, ds)                       # warm-up (cuDNN plans)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        dp, ds = step(dp, ds)
    _sync(dev)
    dt = time.perf_counter() - t0
    out = {"img_per_s": steps * batch_size / dt, "s_per_step": dt / steps,
           "rss_mb": _rss_mb()}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _spread(rounds) -> str:
    ms = [1e3 * r["s_per_step"] for r in rounds]
    return f"{min(ms):.3f}-{max(ms):.3f} ms"


def run(steps: int = 8, batch_size: int = 8, rounds: int = 2,
        cfg: Optional[G.GAN3DConfig] = None, device="cuda",
        work_dir: Optional[Path] = None) -> List[Tuple[str, float, str]]:
    """The reference's four rows ``(name, us, observation)``, plus
    ``device_peak_delta_mb`` on a card.  Bare and capsule rounds
    interleave and each mode keeps its fastest (the paper's Table 2
    measures steady-state throughput; interleaving cancels order and
    warm-cache effects).  ``work_dir`` holds the deployment (default a
    temporary directory); ``cfg`` defaults to the reference's cut
    config."""
    cfg = cfg or CUT_CONFIG
    with tempfile.TemporaryDirectory() as td:
        pipe = D.DeploymentPipeline()
        dep = pipe.deploy(D.pytorch_image("bench"), Path(work_dir or td))
        bares, conts = [], []
        for _ in range(rounds):
            bares.append(_train(steps, batch_size, cfg, device))
            conts.append(dep.run(_train, steps, batch_size, cfg,
                                 device)[0].value)
    bare = min(bares, key=lambda r: r["s_per_step"])
    contained = min(conts, key=lambda r: r["s_per_step"])
    rows = [
        ("3dgan_d_step/with_capsule", contained["s_per_step"] * 1e6,
         f"img_per_s={contained['img_per_s']:.2f}"),
        ("3dgan_d_step/bare", bare["s_per_step"] * 1e6,
         f"img_per_s={bare['img_per_s']:.2f}"),
        ("capsule_overhead_pct",
         abs(contained["s_per_step"] - bare["s_per_step"]) * 1e6,
         f"{100*(contained['s_per_step']/bare['s_per_step']-1):+.2f}% "
         f"(rounds: bare {_spread(bares)}, capsule {_spread(conts)})"),
        ("rss_delta_mb", 0.0,
         f"{contained['rss_mb'] - bare['rss_mb']:+.1f}MB"),
    ]
    if "peak_bytes" in bare:
        mb = (contained["peak_bytes"] - bare["peak_bytes"]) / 2**20
        rows.append(("device_peak_delta_mb", 0.0,
                     f"{mb:+.1f}MB (bare {bare['peak_bytes'] / 2**20:.1f}MB)"))
    return rows


def main(argv=None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's cut config (CPU-sized)")
    ap.add_argument("--out", default="BENCH_torch_container_overhead.json")
    args = ap.parse_args(argv)
    rows = run(args.steps, args.batch, args.rounds,
               CUT_CONFIG if args.smoke else G.GAN3DConfig(), args.device)
    for r in rows:
        print(",".join(str(x) for x in r))
    Path(args.out).write_text(json.dumps(
        {"benchmark": "container_overhead", "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
