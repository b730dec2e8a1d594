"""Quickstart for the PyTorch port: the paper's workflow end to end.

1. Build the PyTorch image on the "workstation" (its requirements resolved
   against the port's offline index; the cluster never touches the
   network).
2. Deploy it through the Charliecloud-style pipeline (flatten -> transfer
   -> unpack) and render the Slurm script, whose payload is the port's
   launcher.
3. Inside the capsule, train qwen2-0.5b through that launcher with
   ``--strategy dp`` (Horovod-style: ``hvd.init``, the gradients averaged by
   allreduce; world size 1 here) and show the loss going down.

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # the card
      PYTHONPATH=src python examples/torch_quickstart.py --smoke --device cpu

Without ``--smoke`` it trains the full-width model (seq 1024, batch 8) and
needs a card; ``--smoke`` takes the smoke config at seq 64.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.core import deploy as D
from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' trains on gloo)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config, CPU-sized")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    launcher_argv = ["--arch", "qwen2-0.5b", "--strategy", "dp",
                     "--device", args.device, "--steps", str(args.steps),
                     "--global-batch", "8"]
    launcher_argv += (["--smoke", "--seq-len", "64", "--lr", "2e-3"]
                      if args.smoke else ["--seq-len", "1024"])

    print("== 1. build + deploy the capsule (paper §III-B) ==")
    with tempfile.TemporaryDirectory() as td:
        pipe = D.DeploymentPipeline()
        dep = pipe.deploy(D.pytorch_image("quickstart"), Path(td), nodes=4,
                          script=f"{D.LAUNCHER} {' '.join(launcher_argv)}")
        for line in dep.log:
            print("  ", line)
        print("\n== 2. the generated Slurm submission (paper §IV-C) ==")
        print("  ", dep.slurm_script.splitlines()[-1])
        print("\n== 3. Horovod-DP training inside the capsule ==")
        results = dep.run(train.main, launcher_argv, ranks=1)
        losses = results[0].value["losses"]
        print(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'DOWN' if losses[-1] < losses[0] else 'up?!'})")
        print(f"\ncapsule run complete: image={results[0].image} "
              f"uid_map='{results[0].uid_map}' "
              f"wall={results[0].wall_time_s:.1f}s")
    return results[0].value


if __name__ == "__main__":
    main()
