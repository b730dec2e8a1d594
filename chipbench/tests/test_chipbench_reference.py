"""The plain reference against the port at the smoke configs, in f32."""
import numpy as np
import pytest
import torch

from chipbench import core, weights
from chipbench.reference import model as M
from chipbench.reference import train as R
from chipbench.traffic import train_steps
import chipbench_cpu as C


def _setup(arch, dtype):
    cfgd = C.smoke_config(arch)
    cfg = core.port_config(cfgd).with_(dtype="float32")
    params = weights.draw(weights.port_layout(cfg, dtype), 11, "cpu")
    return cfgd, cfg, params


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_reference_logits_equal_the_ports_forward(arch):
    from repro_torch.models import transformer as T
    cfgd, cfg, params = _setup(arch, torch.float32)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))
    want = T.forward(params, cfg, {"tokens": tok})[0]
    got = M.logits(params, cfgd, tok)
    assert (got - want).abs().max() < 1e-4 * max(1.0, want.abs().max())


def test_ragged_pass_equals_one_sequence_at_a_time():
    cfgd, _, params = _setup("qwen3-moe-30b-a3b", torch.bfloat16)
    a, b = torch.arange(20) % 300, (torch.arange(13) * 7) % 300
    ra, rb = M.hidden_ragged(params, cfgd, [a, b])
    assert (ra - M.hidden(params, cfgd, a[None])[0]).abs().max() < 1e-5
    assert (rb - M.hidden(params, cfgd, b[None])[0]).abs().max() < 1e-5


def test_reference_steps_equal_the_ports_train_step():
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    from repro_torch.launch.mesh import make_host_mesh
    cfgd, cfg, params = _setup("qwen2-0.5b", torch.float32)
    cfg = cfg.with_(remat=False)
    o = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.0, "clip_norm": 1.0}
    batches = train_steps.markov_batches(cfg.vocab_size, 4, 16, 3, 1, 0.3)
    ref = R.readings(params, cfgd, batches, o, rows=2)
    opt = optim.adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      clip_norm=o["clip_norm"])
    with hvd.init("cpu") as dev:
        groups = make_host_mesh()
        p = weights.draw(weights.port_layout(cfg, torch.float32), 11, dev)
        p, state = stepfn.shard_state(p, cfg, opt, "dp_tp", groups)
        step = stepfn.make_train_step(cfg, opt, groups, strategy="dp_tp",
                                      device=dev)
        losses = []
        for i, b in enumerate(batches):
            p, state, m = step(p, state, {"tokens": b, "labels": b})
            losses.append(float(m["loss"]))
            if i == 0:
                grads = train_steps.leaf_norms(state["mu"], 10.0)
        start = dict(weights.leaves(params))
        change = {k: float((t - start[k]).norm())
                  for k, t in weights.leaves(p)}
    keep = R.kept_leaves(ref["grad_norms"])
    assert R.loss_gap(losses, ref["losses"]) < 1e-5
    assert R.leaf_gap(grads, ref["grad_norms"], keep)[0] < 1e-4
    assert R.leaf_gap(change, ref["change_norms"], keep)[0] < 1e-4


def test_fp8_products_round_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 300.0, -448.0])
    q = M.q8(x)
    assert q[-1] == -448.0 and q[2] == 1.125
    assert (q - x).abs().max() > 0
    a, w = torch.randn(5, 8), torch.randn(8, 3)
    assert (M.q8_matmul(a, w) - a @ w).abs().max() > 1e-3
