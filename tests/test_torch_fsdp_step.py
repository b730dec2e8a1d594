"""The ``fsdp_tp`` train step on gloo against the reference's on the same
``(data, model)`` mesh of host devices, at (2, 2) (without remat: the
model group's all_reduce bytes are checked against a formula from the
activations' shapes) and (1, 4) (gemma2-27b smoke's 2 KV heads do not
split over 4: the ``fit_spec`` fallback; qwen3-moe's 4 experts one a
rank).  The cases, configs, loss variants (plain and chunked), checks
and tolerances are ``test_torch_sharded_step.py``'s (its helpers run
both files).

The other families under ``fsdp_tp`` at (1, 2), against the port's own
``dp`` step at world size 1 on the same weights and the launcher's batch
(``family_batch``), in f32: mamba2 and zamba2 (each mamba2 layer made
whole and run replicated on the model ranks; zamba2's shared block
tensor-parallel), whisper (the encoder's layers and leaves gathered,
cross-attention tensor-parallel), qwen2-vl (M-RoPE positions split on
their batch axis).  One SGD step at lr 1 reads each gradient off the
parameters (as ``tests/test_torch_dp.py``'s vlm case does): the loss
rtol 1e-5 and every gradient within 1e-5 absolute, the DP tolerances
(f32 sums in another order; no AdamW to amplify them).
"""
import json

import numpy as np
import pytest

from repro_torch.core import hvd
from test_torch_sharded_step import (FSDP_MESHES, LOSS_RTOL,
                                     check_chunked_equals_plain, check_mesh,
                                     launches, run_reference)

GRAD_ATOL = 1e-5

FAMILIES = ["mamba2-1.3b", "zamba2-1.2b", "whisper-small", "qwen2-vl-72b"]

FAMILY_PROG = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.configs import get_smoke_config
from repro_torch.core import hvd
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.distributed import sharding as sh, stepfn
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import family_batch
from repro_torch.models import transformer as T
store, out, strategy = sys.argv[1], sys.argv[2], sys.argv[3]
archs = json.loads(sys.argv[4])
world = int(os.environ["WORLD_SIZE"])
res = {}
with hvd.init("cpu", init_method=store):
    groups = make_mesh((1, world), ("data", "model"))
    for arch in archs:
        cfg = get_smoke_config(arch).with_(dtype="float32")
        full = T.init_params(cfg, torch.Generator().manual_seed(0),
                             weight_dtype=torch.float32)
        before = bridge.to_flat(full)
        opt = optim.sgd(1.0)
        if strategy == "dp":
            params, state = full, opt.init(full)
        else:
            params, state = stepfn.shard_state(full, cfg, opt, strategy,
                                               groups)
        step = stepfn.make_train_step(cfg, opt, groups, strategy=strategy,
                                      device="cpu")
        src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 24, 2))
        params, state, m = step(params, state,
                                family_batch(cfg, src.batch(0), 0))
        if strategy != "dp":
            params = sh.unshard(params, step.specs, groups)
        res[arch] = float(m["loss"])
        after = bridge.to_flat(params)
        if groups.world.rank == 0:
            np.savez(os.path.join(out, f"{arch}.npz"),
                     **{k: before[k] - after[k] for k in before})
if groups.world.rank == 0:
    json.dump(res, open(os.path.join(out, "res.json"), "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("reference"), FSDP_MESHES)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, reference):
    return launches(tmp_path_factory, reference)


@pytest.mark.parametrize("label", list(FSDP_MESHES))
def test_fsdp_steps_match_the_reference(label, reference, mesh_runs):
    check_mesh(label, reference, mesh_runs(label))


@pytest.mark.parametrize("label", list(FSDP_MESHES))
def test_chunked_fsdp_steps_match_the_reference(label, reference, mesh_runs):
    check_mesh(label, reference, mesh_runs(label), "-chunked")


@pytest.mark.parametrize("label", list(FSDP_MESHES))
def test_chunked_fsdp_loss_equals_the_plain_one(label, mesh_runs):
    check_chunked_equals_plain(label, mesh_runs(label))


def test_other_families_fsdp_tp_match_dp(tmp_path):
    runs = {}
    for strategy, world in (("dp", 1), ("fsdp_tp", 2)):
        d = tmp_path / strategy
        d.mkdir()
        hvd.run_ranks(FAMILY_PROG, world, d, strategy, json.dumps(FAMILIES),
                      timeout=300)
        runs[strategy] = (d, json.loads((d / "res.json").read_text()))
    (dd, want), (fd, got) = runs["dp"], runs["fsdp_tp"]
    for arch in FAMILIES:
        np.testing.assert_allclose(got[arch], want[arch], rtol=LOSS_RTOL,
                                   err_msg=arch)
        w, g = dict(np.load(dd / f"{arch}.npz")), dict(np.load(
            fd / f"{arch}.npz"))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=GRAD_ATOL,
                                       err_msg=f"{arch} {k}")
