"""The port's three measurements of the paper, on the CPU at the
reference's cut sizes: the capsule against bare (Tables 2-3,
``benchmarks/container_overhead.py``), allreduce against the parameter
server (§II-H, ``allreduce_vs_ps.py``) and the scaling model with the
measured allreduce bytes (Table 1 / Fig. 2, ``scaling.py``).

Byte counts are exact: they are what ``hvd``'s counters saw, by the
reference's definition (the sum of each collective's output).  The scaling
model is numpy on the same constants as the reference's, so its rows must
be equal, not close.
"""
import torch

from repro_torch import bridge
from repro_torch.benchmarks import allreduce_vs_ps, container_overhead
from repro_torch.benchmarks import scaling
from repro_torch.core import container as C
from repro_torch.core import deploy as D

torch.set_num_threads(2)


def _bytes(row) -> int:
    return int(row[2].split()[0].replace(",", ""))


def test_container_overhead_rows_and_the_image_left_unchanged(tmp_path):
    rows = container_overhead.run(steps=2, batch_size=8, rounds=2,
                                  cfg=container_overhead.CUT_CONFIG,
                                  device="cpu", work_dir=tmp_path / "dep")
    assert [r[0] for r in rows] == [
        "3dgan_d_step/with_capsule", "3dgan_d_step/bare",
        "capsule_overhead_pct", "rss_delta_mb"]
    assert rows[0][1] > 0 and rows[1][1] > 0
    assert "% (rounds: bare " in rows[2][2] and rows[3][2].endswith("MB")
    # the unpacked tree after the runs equals a fresh unpack of the image
    used = tmp_path / "dep" / "cluster" / "tmpfs" / "bench"
    image = C.ImageBuilder(D.DeploymentPipeline().index).build(
        D.pytorch_image("bench"))
    fresh = C.unpack(C.flatten(image, tmp_path / "ws"), tmp_path / "fresh")
    assert C._tree_hash(used) == C._tree_hash(fresh)


def test_allreduce_moves_fewer_bytes_than_the_parameter_server():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as T
    cfg = ModelConfig(name="t", family="dense", num_layers=4, d_model=256,
                      num_heads=8, num_kv_heads=4, d_ff=1024,
                      vocab_size=32000)
    p = T.init_params(cfg, torch.Generator().manual_seed(0))
    n = sum(v.size for v in bridge.to_flat(p).values())
    ranks = 4
    rows = allreduce_vs_ps.run(ranks=ranks, device="cpu")
    assert [r[0] for r in rows] == ["hvd_allreduce/4ranks",
                                    "paramserver/4ranks", "ps_vs_hvd_ratio"]
    # hvd: the gradient's all_reduce and the four f32 metrics'
    assert _bytes(rows[0]) == 4 * n + 16
    # ps: every rank's gradient gathered (N x), the parameters broadcast,
    # the metrics
    assert _bytes(rows[1]) == (ranks + 1) * 4 * n + 16
    assert _bytes(rows[1]) > _bytes(rows[0])


def test_scaling_model_rows_equal_the_reference():
    from benchmarks import scaling as ref
    assert scaling.model_vs_paper() == ref.model_vs_paper()
    for n in (4, 8, 16, 32):
        assert scaling.epoch_time_model(n, 3000.0) == \
            ref.epoch_time_model(n, 3000.0)


def test_measured_allreduce_bytes_are_the_cut_discriminator_gradient():
    from repro_torch.models import gan3d as G
    dp = G.init_discriminator(container_overhead.CUT_CONFIG,
                              torch.Generator().manual_seed(1))
    assert scaling.measured_allreduce_bytes(2, device="cpu") == \
        4 * G.param_count(dp)
