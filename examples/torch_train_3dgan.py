"""Train the CERN 3DGAN (the paper's §IV/§V workload) with Horovod-style
DP on the PyTorch port (the counterpart of ``examples/train_3dgan.py``).

The full paper pipeline, as the reference's docstring describes it:
deploy an environment capsule (the PyTorch image built against the
port's offline index, flattened, transferred and unpacked by
``core/deploy.py``), then inside it (``CapsuleRuntime.run``) train the
~1M-parameter 3D convolutional ACGAN on synthetic CLIC calorimeter
showers with RMSProp, gradients exchanged by allreduce over the data axis
(``core/hvd.py``; one rank per device, the paper's one-rank-per-node
layout): the port's launcher ``repro_torch.launch.train_3dgan``, whose
loop is the reference example's (D at half the G rate, losses every 10
steps, img/s, the energy-response correlation).

Run:  PYTHONPATH=src python examples/torch_train_3dgan.py --steps 100
      PYTHONPATH=src python examples/torch_train_3dgan.py --device cpu \\
          --steps 4
      PYTHONPATH=src torchrun --nproc-per-node 2 \\
          examples/torch_train_3dgan.py --device cpu --steps 4

``--device`` defaults to ``cuda`` (NCCL) and fails without a card;
``--device cpu`` trains on gloo.  Under ``torchrun`` every rank deploys
the image into its own temporary directory and runs inside it.
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.core import deploy as D
from repro_torch.launch import train_3dgan


def main(argv=None) -> dict:
    """Deploys the capsule and trains inside it; returns the launcher's
    numbers (losses, img/s, the collectives a step, the energy
    correlation) with the capsule's image name and wall time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, NCCL; 'cpu' runs on "
                         "gloo)")
    args = ap.parse_args(argv)
    launcher_argv = ["--steps", str(args.steps), "--batch", str(args.batch),
                     "--lr", str(args.lr), "--device", args.device]
    from repro_torch.serving.engine import resolve_device
    resolve_device(args.device)                 # no card: fail up front

    print("== deploy the capsule (paper §III-B) ==")
    with tempfile.TemporaryDirectory() as td:
        dep = D.DeploymentPipeline().deploy(
            D.pytorch_image("3dgan"), Path(td),
            script=f"-m repro_torch.launch.train_3dgan "
                   f"{' '.join(launcher_argv)}")
        for line in dep.log:
            print("  ", line)
        print("\n== Horovod-DP 3DGAN training inside the capsule ==")
        res = dep.run(train_3dgan.main, launcher_argv)[0]
        print(f"\ncapsule run complete: image={res.image} "
              f"uid_map='{res.uid_map}' wall={res.wall_time_s:.1f}s")
    return dict(res.value, image=res.image, wall_time_s=res.wall_time_s)


if __name__ == "__main__":
    main()
