"""The paper's deployment story, blow by blow (§II-A, §III-B, §IV), on the
PyTorch port's modules.

Demonstrates every failure mode the paper describes and the capsule fix:
  1. shared-Python dependency breakage (TensorFlow-then-Caffe),
  2. pip-install-on-the-cluster dying (air gap),
  3. Docker/Singularity refused by site security policy,
  4. the Charliecloud build->flatten->transfer->unpack->run path succeeding
     for the PyTorch image,
  5. the 32-node Slurm script (§IV-C), whose payload is the port's launcher.

Run:  PYTHONPATH=src python examples/torch_deploy_supermuc.py    # the card
      PYTHONPATH=src python examples/torch_deploy_supermuc.py --device cpu

The capsule's ``ch-run`` makes one tensor on ``--device`` (default
``cuda``, which fails without a card).
"""
import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.core import container as C
from repro_torch.core import deploy as D
from repro_torch.core import registry as R


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.serving.engine import resolve_device
    dev = resolve_device(args.device)
    idx = R.default_index()

    print("== 1. the shared-Python failure (paper §II-A) ==")
    env = R.SharedEnvironment(idx)
    env.pip_install("tensorflow==1.11.0")
    print("  installed tensorflow 1.11:", not env.check())
    env.pip_install("caffe==1.0.0")
    for root, problems in env.check().items():
        print(f"  BROKEN {root}: {problems}")

    print("\n== 2. pip install on the cluster dies (air gap) ==")
    try:
        C.CLUSTER.require_internet("pip install torch")
    except R.OfflineViolation as e:
        print("  OfflineViolation:", e)

    print("\n== 3. site security policy (paper §II-C..F) ==")
    pol = C.SecurityPolicy()
    for rt in ("docker", "singularity", "shifter", "charliecloud"):
        try:
            pol.admit(C.RUNTIME_PROFILES[rt])
            print(f"  {rt}: ADMITTED")
        except C.SecurityError as e:
            print(f"  {rt}: refused — {e}")

    print("\n== 4. the Charliecloud path (paper §III-B) ==")
    with tempfile.TemporaryDirectory() as td:
        pipe = D.DeploymentPipeline(index=idx)
        dep = pipe.deploy(D.pytorch_image(), Path(td),
                          nodes=32, ranks_per_node=1)
        for line in dep.log:
            print("  ", line)
        print("   packages:", dict(sorted(dep.image.packages.items())))
        res = dep.run(lambda: "hello from inside the capsule, "
                      f"{torch.ones(2, device=dev).sum().item():.0f} ones "
                      f"summed on {dev}", ranks=2)
        print("   ch-run:", res[0].value, f"[uid_map {res[0].uid_map}]")

        print("\n== 5. Slurm submission (§IV-C, 32 nodes) ==")
        print("\n".join("   " + l for l in dep.slurm_script.splitlines()))


if __name__ == "__main__":
    main()
