"""Paper Table 1 / Fig 2: multi-node scaling of the 3DGAN training (the
port of ``benchmarks/scaling.py``).

The paper reports near-linear strong scaling of one 3DGAN epoch on 4-32
SuperMUC-NG nodes (3806s -> 504s, 94% efficiency).  Two parts, as the
reference's:

1. **Cost model**, the port's own copy (numpy only; its rows equal the
   reference's): per-epoch time = compute/N + ring-allreduce time with the
   paper's hardware (Skylake 48c, OmniPath 100 Gbit/s, 1M-param f32
   gradients, steps/epoch from the dataset size), its one free parameter
   fitted to the paper's Table 1 at 4 nodes.  The times are the paper's
   SuperMUC-NG numbers and the model's, not measurements of this port.

2. **Collective bytes, measured**: the D step of the reference's cut
   3DGAN config through ``hvd.make_train_step`` on 2..32 ranks
   (``hvd.run_ranks``: NCCL with one card a rank on ``--device cuda``, the
   default, gloo on ``--device cpu``), the bytes of each rank's gradient
   all_reduce read from ``hvd``'s counters: constant in N, the O(P)
   per-rank property that makes (1) hold.

  PYTHONPATH=src python -m repro_torch.benchmarks.scaling --device cpu \\
      [--full | --ranks 2 4]

Rows go to stdout as CSV and to ``BENCH_torch_scaling.json``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hvd

# paper Table 1
PAPER_TABLE1 = {4: 3806.0, 8: 1910.0, 16: 1001.0, 32: 504.0}

# SuperMUC-NG constants
OMNIPATH_BW = 100e9 / 8            # bytes/s
GAN_PARAMS = 1.0e6                 # paper: "slightly less than 1 million"
GRAD_BYTES = GAN_PARAMS * 4


def epoch_time_model(nodes: int, t_compute_4: float,
                     steps_per_epoch: int = 6000,
                     inter_island_penalty: float = 4.0) -> float:
    """t(N) = serial_compute/N + steps * ring_allreduce(N).

    ring allreduce moves 2*(N-1)/N * grad_bytes per rank per step; beyond
    one island (>= 24 nodes here) the pruned 4:1 fat-tree divides effective
    bandwidth (paper §III-A).
    """
    compute = t_compute_4 * 4 / nodes
    bw = OMNIPATH_BW / (inter_island_penalty if nodes > 24 else 1.0)
    allreduce = steps_per_epoch * 2 * (nodes - 1) / nodes * GRAD_BYTES / bw
    # per-step framework overhead (launch, host sync) ~ constant
    overhead = steps_per_epoch * 2e-3
    return compute + allreduce + overhead


def model_vs_paper() -> List[Tuple[str, float, str]]:
    # calibrate single free parameter (compute at 4 nodes) on the first row
    t4 = PAPER_TABLE1[4]
    steps = 6000
    t_compute_4 = t4 - epoch_time_model(4, 0.0, steps)     # residual=comm
    rows = []
    for n, t_paper in PAPER_TABLE1.items():
        t_model = epoch_time_model(n, t_compute_4, steps)
        err = 100 * (t_model - t_paper) / t_paper
        rows.append((f"table1_model/{n}nodes", t_model * 1e6,
                     f"paper={t_paper:.0f}s model={t_model:.0f}s "
                     f"err={err:+.1f}%"))
    t4m = epoch_time_model(4, t_compute_4, steps)
    t32m = epoch_time_model(32, t_compute_4, steps)
    eff = t4m * 4 / (t32m * 32) * 100
    rows.append(("table1_model/scaling_efficiency_32n", 0.0,
                 f"{eff:.1f}% (paper claims ~94%)"))
    return rows


_PROG = """
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch import optim
from repro_torch.core import hvd
from repro_torch.data import CalorimeterSpec, generate_batch
from repro_torch.models import gan3d as G
store, out, device = sys.argv[1], sys.argv[2], sys.argv[3]
cfg = G.GAN3DConfig(g_fc_ch=6, g_base=16, d_base=8)
with hvd.init(device, init_method=store) as dev:
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = hvd.axis_groups({"data": world})
    gp = G.init_generator(cfg, torch.Generator().manual_seed(0), device=dev)
    dp = G.init_discriminator(cfg, torch.Generator().manual_seed(1),
                              device=dev)
    d_opt = optim.rmsprop(1e-3)
    step = hvd.make_train_step(
        lambda d, b, z: G.d_loss(d, gp, cfg, b, z), d_opt, groups)
    rows = slice(2 * rank, 2 * rank + 2)
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in
             generate_batch(CalorimeterSpec(), 2 * world).items()}
    z = torch.randn(2 * world, cfg.latent_dim,
                    generator=torch.Generator().manual_seed(2))[rows].to(dev)
    groups.reset_counts()
    dp, _, metrics = step(dp, d_opt.init(dp), batch, z)
    g = groups["data"]
    res = {"output_bytes": g.output_bytes(), "kinds": g.kinds,
           "metrics_bytes": sum(m.numel() * m.element_size()
                                for m in metrics.values()),
           "d_params": G.param_count(dp)}
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
"""


def measured_allreduce_bytes(ranks: int, device="cuda") -> int:
    """One D step of the reference's cut 3DGAN config through
    ``hvd.make_train_step`` on ``ranks`` ranks of ``device``: the bytes of
    rank 0's gradient all_reduce (its output, the reference's measure),
    from ``hvd``'s counters less the step's averaged metrics, which the
    reference's measured step does not exchange."""
    with tempfile.TemporaryDirectory() as td:
        hvd.run_ranks(_PROG, ranks, td, device, device=device, timeout=560.0)
        res = json.loads(Path(td, "rank0.json").read_text())
    return res["output_bytes"] - res["metrics_bytes"]


def run(quick: bool = True, device="cuda",
        sizes: Optional[Sequence[int]] = None
        ) -> List[Tuple[str, float, str]]:
    """The model's rows, then the measured bytes at ``sizes`` ranks
    (default 2 and 8, or 2 to 32 without ``quick``) on ``device``."""
    rows = model_vs_paper()
    sizes = sizes or ([2, 8] if quick else [2, 4, 8, 16, 32])
    per_rank: Dict[int, int] = {}
    for n in sizes:
        per_rank[n] = measured_allreduce_bytes(n, device)
        rows.append((f"allreduce_bytes/{n}ranks", 0.0,
                     f"{per_rank[n]:,} B/rank/step"))
    # O(2P) property: per-rank bytes ~ constant in N (ring allreduce)
    vals = list(per_rank.values())
    ratio = max(vals) / max(min(vals), 1)
    rows.append(("allreduce_bytes/flatness", 0.0,
                 f"max/min={ratio:.2f} (ring allreduce: ~2x grad bytes, "
                 f"constant per rank)"))
    return rows


def main(argv=None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="2, 4, 8, 16 and 32 ranks (default 2 and 8)")
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="the rank counts to measure (overrides --full)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one card a rank) or cpu "
                         "(gloo)")
    ap.add_argument("--out", default="BENCH_torch_scaling.json")
    args = ap.parse_args(argv)
    rows = run(quick=not args.full, device=args.device, sizes=args.ranks)
    for r in rows:
        print(",".join(str(x) for x in r))
    Path(args.out).write_text(json.dumps(
        {"benchmark": "scaling", "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
