"""Paper §II-H: Horovod allreduce against TensorFlow's parameter servers
(the port of ``benchmarks/allreduce_vs_ps.py``'s measurement).

The same training step (the reference's 4-layer LM, ``lm_loss``, RMSProp)
under ``hvd.make_train_step`` and under ``paramserver.make_train_step`` on
``ranks`` ranks (``hvd.run_ranks``: each a ``python -c`` subprocess joined
through a ``file://`` store; NCCL with one card a rank on ``--device
cuda``, the default, gloo on ``--device cpu``).  Each rank runs one step of each and reports the bytes
of its collectives by the reference's definition
(``launch.dryrun.collective_bytes``: the sum of each collective's output,
so an all_gather counts ``ranks`` x what it was handed, an all_reduce or a
broadcast 1x; ``hvd.Group.output_bytes``): ring allreduce moves O(P) per
rank, the PS pattern's all_gather + broadcast O(N P), the contrast that
moved the paper (and Horovod) to allreduce.

  PYTHONPATH=src python -m repro_torch.benchmarks.allreduce_vs_ps \\
      --device cpu [--ranks 8]

Rows go to stdout as CSV and to ``BENCH_torch_allreduce_vs_ps.json``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.core import hvd

_PROG = """
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hvd, paramserver
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.models import transformer as T
store, out, device = sys.argv[1], sys.argv[2], sys.argv[3]
cfg = ModelConfig(name="t", family="dense", num_layers=4, d_model=256,
                  num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=32000)
res = {}
with hvd.init(device, init_method=store) as dev:
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = hvd.axis_groups({"data": world})
    batch = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 128,
                                                  2 * world)).batch(0)
    shard = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(dev)
             for k, v in batch.items()}
    loss_fn = lambda p, b: T.lm_loss(p, cfg, b)
    for name, maker in (("hvd", hvd.make_train_step),
                        ("ps", paramserver.make_train_step)):
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev, weight_dtype=torch.float32)
        opt = optim.rmsprop(1e-3)
        step = maker(loss_fn, opt, groups)
        groups.reset_counts()
        step(params, opt.init(params), shard)
        w = groups.world
        res[name] = {"output_bytes": w.output_bytes(), "calls": w.calls,
                     "kinds": w.kinds}
    res["n_params"] = sum(v.size for v in bridge.to_flat(params).values())
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
"""


def measure(ranks: int, device="cuda") -> List[Dict]:
    """One step of each builder on ``ranks`` ranks of ``device``: every
    rank's ``{"hvd": {...}, "ps": {...}, "n_params": P}``."""
    with tempfile.TemporaryDirectory() as td:
        hvd.run_ranks(_PROG, ranks, td, device, device=device, timeout=560.0)
        return [json.loads(Path(td, f"rank{r}.json").read_text())
                for r in range(ranks)]


def run(ranks: int = 8, device="cuda") -> List[Tuple[str, float, str]]:
    reports = measure(ranks, device)
    res = reports[0]
    hvd_b, ps_b = res["hvd"]["output_bytes"], res["ps"]["output_bytes"]
    grad_bytes = res["n_params"] * 4
    rows = [
        (f"hvd_allreduce/{ranks}ranks", 0.0,
         f"{hvd_b:,} B/rank ({hvd_b/grad_bytes:.2f}x grad bytes)"),
        (f"paramserver/{ranks}ranks", 0.0,
         f"{ps_b:,} B/rank ({ps_b/grad_bytes:.2f}x grad bytes)"),
        ("ps_vs_hvd_ratio", 0.0,
         f"{ps_b/max(hvd_b,1):.2f}x more collective traffic "
         f"(paper: why Horovod replaced parameter servers)"),
    ]
    assert ps_b > hvd_b, "PS must move more bytes than allreduce"
    return rows


def main(argv=None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one card a rank) or cpu "
                         "(gloo)")
    ap.add_argument("--out", default="BENCH_torch_allreduce_vs_ps.json")
    args = ap.parse_args(argv)
    rows = run(args.ranks, args.device)
    for row in rows:
        print(",".join(str(x) for x in row))
    Path(args.out).write_text(json.dumps(
        {"benchmark": "allreduce_vs_ps", "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
