"""Train the CERN 3DGAN (the paper's workload) with Horovod-style data
parallelism (the port of ``examples/train_3dgan.py``'s flow).

The ~1.05 M-parameter 3-D convolutional ACGAN on synthetic CLIC
calorimeter showers: each step a D step, then a G step, each through
``hvd.make_train_step`` (gradients averaged by allreduce over the
``data`` axis before the update, one rank per device), RMSProp with
global-norm clipping at 1.0, D at half the G rate.  Each rank draws its
shard of the global batch from ``CalorimeterSource(spec, batch, rank,
world_size)``; z is the rank's rows of one global draw from a
``torch.Generator`` (seed 2), so a run's z does not depend on the world
size.  Weights are random from seeds 0 (G) and 1 (D), broadcast from rank
0 as Horovod's recipe does.  Prints the losses every 10 steps, images/s
and the energy-response correlation; returns the run's numbers.

  PYTHONPATH=src python -m repro_torch.launch.train_3dgan --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train_3dgan --smoke \\
      --device cpu --steps 2
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.train_3dgan --steps 50 --batch 64

``--device`` defaults to ``cuda`` (NCCL) and fails without a card;
``--device cpu`` trains on gloo.
"""
from __future__ import annotations

import argparse
import time


def _mean(xs) -> float:
    return sum(xs) / len(xs)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the ranks)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, NCCL; 'cpu' runs on "
                         "gloo)")
    return ap


def main(argv=None) -> dict:
    """Runs the training loop; returns losses, seconds per (D, G) pair
    and per batch made, images/s (the global batch over a step with its
    data), the collectives each step issued, the energy-response
    correlation and, on a card, peak device memory."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs.gan3d import CONFIG, SMOKE_CONFIG
    from repro_torch.core import hvd
    from repro_torch.data import CalorimeterSource, CalorimeterSpec
    from repro_torch.models import gan3d as G

    cfg = SMOKE_CONFIG if args.smoke else CONFIG
    with hvd.init(args.device) as device:
        import torch.distributed as dist
        world_size, rank = dist.get_world_size(), dist.get_rank()
        if args.batch % world_size != 0:
            raise ValueError(f"--batch {args.batch} is not a multiple of the "
                             f"world size {world_size}")
        local = args.batch // world_size
        groups = hvd.axis_groups({"data": world_size})
        lead = rank == 0
        if lead:
            print(f"world_size={world_size} backend={dist.get_backend()} "
                  f"device={device} global_batch={args.batch} (paper: "
                  f"RMSProp, allreduce DP)")

        gp = G.init_generator(cfg, torch.Generator().manual_seed(0), device)
        dp = G.init_discriminator(cfg, torch.Generator().manual_seed(1),
                                  device)
        gp = hvd.broadcast(gp, groups.world)
        dp = hvd.broadcast(dp, groups.world)
        if lead:
            print(f"G params: {G.param_count(gp):,}  "
                  f"D params: {G.param_count(dp):,}")

        # D at half the G rate: keeps the adversary from overpowering the
        # generator in short runs (the paper trains far longer at scale)
        d_opt = optim.rmsprop(args.lr * 0.5, clip_norm=1.0)
        g_opt = optim.rmsprop(args.lr, clip_norm=1.0)
        ds, gs = d_opt.init(dp), g_opt.init(gp)
        d_step = hvd.make_train_step(
            lambda d, g, b, z: G.d_loss(d, g, cfg, b, z), d_opt, groups)
        g_step = hvd.make_train_step(
            lambda g, d, b, z: G.g_loss(g, d, cfg, b, z), g_opt, groups)

        source = CalorimeterSource(CalorimeterSpec(), args.batch, rank,
                                   world_size)
        zgen = torch.Generator().manual_seed(2)
        rows = slice(rank * local, (rank + 1) * local)

        def draw_z(n: int):
            return torch.randn(n, cfg.latent_dim, generator=zgen)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        d_losses, g_losses, data_s, pair_s, per_step = [], [], [], [], []
        t0 = time.perf_counter()
        for i in range(args.steps):
            t_data = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in source.batch(i).items()}
            z1 = draw_z(args.batch)[rows].to(device)
            z2 = draw_z(args.batch)[rows].to(device)
            t_pair = time.perf_counter()
            groups.reset_counts()
            dp, ds, dm = d_step(dp, ds, gp, batch, z1)
            gp, gs, gm = g_step(gp, gs, dp, batch, z2)
            d_losses.append(float(dm["d_loss"]))
            g_losses.append(float(gm["g_loss"]))    # waits for the pair
            pair_s.append(time.perf_counter() - t_pair)
            data_s.append(t_pair - t_data)
            calls, nbytes = groups.counts()[("data",)]
            per_step.append({"calls": calls, "bytes": nbytes})
            if lead and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:4d}  d_loss {d_losses[-1]:.4f}  "
                      f"g_loss {g_losses[-1]:.4f}  "
                      f"D(real acc) {float(dm['acc_real']):.2f}  "
                      f"D(fake acc) {float(dm['acc_fake']):.2f}")
        dt = time.perf_counter() - t0
        # step 0 pays the warm-up; a step is its data and its (D, G) pair
        mean_s = _mean(pair_s[1:] or pair_s)
        step_s = mean_s + _mean(data_s[1:] or data_s)
        result = {"world_size": world_size, "backend": dist.get_backend(),
                  "device": str(device), "d_losses": d_losses,
                  "g_losses": g_losses, "pair_s": pair_s, "data_s": data_s,
                  "images_per_s": args.batch / step_s,
                  "collectives_per_step": per_step,
                  "g_params": G.param_count(gp),
                  "d_params": G.param_count(dp)}
        if lead:
            print(f"\n{args.steps} steps in {dt:.1f}s; (D, G) pair "
                  f"{mean_s * 1e3:.2f} ms, step with its data "
                  f"{step_s * 1e3:.2f} ms (means of steps "
                  f"{1 if len(pair_s) > 1 else 0}-{len(pair_s) - 1}); "
                  f"{result['images_per_s']:.1f} img/s")

        # physics sanity: generated total deposition should track the
        # requested energy
        e_test = torch.linspace(50, 400, 8, device=device)
        with torch.no_grad():
            fake = G.generator(gp, cfg, draw_z(8).to(device), e_test)
        totals = fake.sum(dim=(1, 2, 3, 4)).cpu().numpy()
        corr = float(np.corrcoef(e_test.cpu().numpy(), totals)[0, 1])
        result["energy_corr"] = corr
        if lead:
            print(f"corr(requested E, generated deposition) = {corr:.3f}")
        if device.type == "cuda":
            result["device_name"] = torch.cuda.get_device_name(device)
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
            if lead:
                print(f"peak device memory "
                      f"{result['max_memory_allocated'] / 2**20:.1f} MiB on "
                      f"{result['device_name']}")
    return result


if __name__ == "__main__":
    main()
