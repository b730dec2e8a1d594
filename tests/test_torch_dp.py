"""The LM launcher's ``--strategy dp`` over ``core/hvd.py`` on gloo at world
sizes 2 and 4, each rank a ``python -c`` subprocess (joined through a
``file://`` store in the test's temporary directory, no network) that runs
``repro_torch.launch.train.main`` inside ``CapsuleRuntime.run`` on one
unpacked PyTorch image, as ``mpiexec ... ch-run`` starts the ranks.

Checks:
- every step's loss against the port's one-rank run on the whole global
  batch, and the final parameters; in f32 compute (``--dtype float32``),
  so only the reduction order differs (the mean of the ranks' shard means
  against one mean over the batch, gradients summed by all_reduce);
- the ranks' parameters bitwise identical after the last step;
- the bytes each step hands the data group: exactly one gradient
  all_reduce of 4 x (parameter count) bytes and one of the four f32
  metrics;
- the launcher's DP step (``stepfn.make_train_step``, the function the
  launcher builds its step with) at world size 2 from the reference's
  params, bridged, against the reference's ``stepfn.make_train_step(...,
  make_host_mesh(), "dp", ...)`` on the whole batch for 3 steps;
- the vlm family (qwen2-vl smoke, the launcher's batch with its (3, B, S)
  M-RoPE positions) at world size 2 with microbatches 2 against the
  one-rank, one-microbatch step: the loss and the gradients (read off an
  SGD step at lr 1) agree, so each rank and microbatch took its rows of
  ``mrope_positions`` on axis 1, with its own text and patches.

Tolerances: against the one-rank run, losses rtol 1e-5 and parameters
1e-5 absolute (``tests/test_torch_hvd.py``'s DP tolerances; observed
1.7e-7 and 3.3e-6); against the reference, ``tests/test_torch_train.py``'s
f32 train-step tolerances (losses rtol 1e-5, parameters 2e-4 absolute:
AdamW divides each update by its gradient's running magnitude, so entries
whose gradient is near 0 amplify f32 noise; observed 8.3e-8 and 3.2e-5).
The ranks are started by ``hvd.run_ranks``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import deploy as D
from repro_torch.core import hvd

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
REF_PARAM_ATOL = 2e-4
STEPS = 3
LAUNCHER = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--strategy", "dp", "--dtype", "float32", "--steps", str(STEPS),
            "--seq-len", "24", "--global-batch", "8"]

IN_CAPSULE = """
import json, os, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.core import container as cc
from repro_torch.launch import train
store, out, image = sys.argv[1], sys.argv[2], sys.argv[3]
argv = json.loads(sys.argv[4]) + ["--init-method", store]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
res = cc.CapsuleRuntime().run(Path(image), train.main, argv, rank=rank,
                              world_size=world)
v = res.value
np.savez(os.path.join(out, f"params{rank}.npz"), **bridge.to_flat(v["params"]))
json.dump({"losses": v["losses"], "world_size": v["world_size"],
           "backend": v["backend"], "collectives": v["collectives_per_step"],
           "capsule": res.image},
          open(os.path.join(out, f"run{rank}.json"), "w"))
"""

DP_STEP = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.configs import get_smoke_config
from repro_torch.core import hvd
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.distributed import stepfn
store, out = sys.argv[1], sys.argv[2]
spec = json.loads(sys.argv[3])
cfg = get_smoke_config("qwen2-0.5b").with_(dtype="float32")
init = np.load(os.path.join(out, "ref_init.npz"))
with hvd.init("cpu", init_method=store) as dev:
    groups = hvd.axis_groups({"data": int(os.environ["WORLD_SIZE"])})
    opt = optim.adamw(spec["lr"], clip_norm=1.0)
    params = bridge.from_flat({k: init[k] for k in init.files})
    state = opt.init(params)
    step = stepfn.make_train_step(cfg, opt, groups, device="cpu")
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, spec["seq"],
                                                spec["batch"]))
    losses = []
    for i in range(spec["steps"]):
        params, state, m = step(params, state, src.batch(i))
        losses.append(float(m["loss"]))
    rank = groups["data"].rank
np.savez(os.path.join(out, f"dp{rank}.npz"), **bridge.to_flat(params))
json.dump(losses, open(os.path.join(out, f"dp{rank}.json"), "w"))
"""


VLM_STEP = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.configs import get_smoke_config
from repro_torch.core import hvd
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.distributed import stepfn
from repro_torch.launch.train import family_batch
from repro_torch.models import transformer as T
store, out, micro = sys.argv[1], sys.argv[2], int(sys.argv[3])
cfg = get_smoke_config("qwen2-vl-72b").with_(dtype="float32")
with hvd.init("cpu", init_method=store):
    groups = hvd.axis_groups({"data": int(os.environ["WORLD_SIZE"])})
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           weight_dtype=torch.float32)
    opt = optim.sgd(1.0)
    step = stepfn.make_train_step(cfg, opt, groups, microbatches=micro,
                                  device="cpu")
    batch = family_batch(cfg, SyntheticTokenSource(TokenDatasetSpec(
        cfg.vocab_size, 24, 4)).batch(0), 0)
    before = bridge.to_flat(optim.tree_map(torch.clone, params))
    new, _, m = step(params, opt.init(params), batch)
    rank = groups["data"].rank
after = bridge.to_flat(new)
np.savez(os.path.join(out, f"grads{rank}.npz"),
         **{k: before[k] - after[k] for k in before})
json.dump({"loss": float(m["loss"]),
           "shapes": {k: list(v.shape) for k, v in batch.items()}},
          open(os.path.join(out, f"vlm{rank}.json"), "w"))
"""


@pytest.fixture(scope="module")
def one_rank():
    """The launcher's one-rank run on the whole global batch (world size 1,
    gloo on a private store): losses and final parameters."""
    from repro_torch.launch import train
    run = train.main(LAUNCHER)
    assert run["world_size"] == 1
    return run


@pytest.mark.parametrize("world", [2, 4])
def test_dp_launcher_in_capsule_matches_the_one_rank_run(world, one_rank,
                                                         tmp_path):
    dep = D.DeploymentPipeline().deploy(D.pytorch_image("dp"), tmp_path,
                                        nodes=world)
    hvd.run_ranks(IN_CAPSULE, world, tmp_path, str(dep.unpacked),
                  json.dumps(LAUNCHER))
    runs = [json.loads((tmp_path / f"run{r}.json").read_text())
            for r in range(world)]
    params = [dict(np.load(tmp_path / f"params{r}.npz"))
              for r in range(world)]
    want = bridge.to_flat(one_rank["params"])
    n = sum(v.size for v in want.values())
    for r, x in enumerate(runs):
        assert (x["world_size"], x["backend"], x["capsule"]) == (
            world, "gloo", "dp")
        # metrics allreduced: every rank reports the same losses
        assert x["losses"] == runs[0]["losses"]
        # one fused f32 gradient all_reduce and the four metrics a step
        assert x["collectives"] == [
            {"calls": 2, "bytes": 4 * n + 16}] * STEPS
        # replicas identical bit for bit
        assert params[r].keys() == want.keys()
        for k in want:
            assert np.array_equal(params[r][k], params[0][k]), (r, k)
    np.testing.assert_allclose(runs[0]["losses"], one_rank["losses"],
                               rtol=LOSS_RTOL)
    for k in want:
        np.testing.assert_allclose(params[0][k], want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_dp_step_matches_the_reference_whole_batch_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro.distributed import stepfn as jstep
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as T

    spec = {"lr": 1e-3, "seq": 24, "batch": 4, "steps": STEPS}
    cfg = get_smoke_config("qwen2-0.5b").with_(dtype="float32")
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    np.savez(tmp_path / "ref_init.npz", **{
        k: np.asarray(v) for k, v in _flatten_with_paths(params).items()})
    opt = jopt.adamw(spec["lr"], clip_norm=1.0)
    step, _, _ = jstep.make_train_step(
        cfg, opt, make_host_mesh(), "dp",
        InputShape("t", spec["seq"], spec["batch"], "train"))
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, spec["seq"],
                                                spec["batch"]))
    state, losses = opt.init(params), []
    for i in range(STEPS):
        params, state, m = step(params, state, {
            k: jnp.asarray(v) for k, v in src.batch(i).items()})
        losses.append(float(m["loss"]))
    want = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}

    hvd.run_ranks(DP_STEP, 2, tmp_path, json.dumps(spec))
    got = [dict(np.load(tmp_path / f"dp{r}.npz")) for r in range(2)]
    got_losses = [json.loads((tmp_path / f"dp{r}.json").read_text())
                  for r in range(2)]
    assert got_losses[0] == got_losses[1]
    np.testing.assert_allclose(got_losses[0], losses, rtol=LOSS_RTOL)
    assert got[0].keys() == want.keys()
    for k in want:
        assert np.array_equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[0][k], want[k], rtol=0,
                                   atol=REF_PARAM_ATOL, err_msg=k)


def test_vlm_dp_splits_mrope_positions_on_their_batch_axis(tmp_path):
    """qwen2-vl smoke at world size 2 with microbatches 2 (one row each)
    against one rank with one microbatch, on the launcher's batch (B 4,
    S 24, 8 patches): the same loss and gradients within the DP
    tolerances, on every rank."""
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    hvd.run_ranks(VLM_STEP, 1, one, "1")
    hvd.run_ranks(VLM_STEP, 2, two, "2")
    want = json.loads((one / "vlm0.json").read_text())
    assert want["shapes"] == {"patch_embeddings": [4, 8, 128],
                              "tokens": [4, 16],
                              "mrope_positions": [3, 4, 24],
                              "labels": [4, 24]}
    want_g = dict(np.load(one / "grads0.npz"))
    for r in range(2):
        got = json.loads((two / f"vlm{r}.json").read_text())
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        got_g = dict(np.load(two / f"grads{r}.npz"))
        assert got_g.keys() == want_g.keys()
        for k in want_g:
            np.testing.assert_allclose(got_g[k], want_g[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
