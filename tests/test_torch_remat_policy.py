"""``cfg.remat_policy`` in the port (``transformer._run``), against the
reference's ``_scan_layers``, which reads it in every remat'd scan:
``"nothing"`` recomputes every activation of a layer body in the
backward, ``"dots"`` saves the outputs of its products with no batch dims
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``; in the
port ``aten.mm`` / ``aten.addmm``, ``transformer._DOTS``) and recomputes
the rest.

One smoke config of each family whose bodies are remat'd: dense
(qwen2-0.5b: layer groups), moe (qwen3-moe-30b-a3b: the router saved, the
experts' batched einsums recomputed), ssm (mamba2-1.3b: mamba layers),
hybrid (zamba2-1.2b: mamba layers, the shared block, the tail), encdec
(whisper-small: encoder and decoder layers) and vlm (qwen2-vl-72b).

Checks:
- a policy decides what the backward keeps, never a value: under
  ``"dots"`` the loss and every gradient equal ``"nothing"``'s bit for
  bit (the config's bf16);
- under ``"dots"`` the backward re-runs no forward product: a dispatch
  mode (``transformer.DotsCounter``) counts the ``mm`` / ``addmm`` calls
  made with grad enabled inside ``torch.autograd.grad`` (the recompute
  runs under grad mode, the gradients' own products without it), none
  under ``"dots"``, some under ``"nothing"``;
- the port under ``"dots"`` against the reference under ``"dots"`` on the
  same bridged weights and batch, in f32: the loss within rtol 1e-5 and
  each gradient leaf's relative norm error within its family's f32
  tolerance of the parity tests (``test_torch_train.py``,
  ``test_torch_moe.py``, ``test_torch_hybrid.py``, ``test_torch_encdec.py``,
  ``test_torch_vlm.py``);
- the dry-run (``launch.dryrun.count_step``, meta tensors) under
  ``"dots"`` peaks above ``"nothing"`` and counts fewer FLOPs (no forward
  product twice), and under ``fsdp_tp`` at (2, 2) hands every group the
  same collectives: each layer group's weights are gathered over
  ``data`` again in the recompute, not saved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.distributed import stepfn as pstep
from repro_torch.launch import dryrun
from repro_torch.launch.train import family_batch
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

SEQ, BATCH = 24, 2
LOSS_RTOL = 1e-5
# each family's f32 gradient tolerance in its parity test file
GRAD_RTOL = {"dense": 1e-4, "moe": 1e-4, "ssm": 1e-5, "hybrid": 1e-5,
             "encdec": 1e-5, "vlm": 1e-5}
ZERO_GRAD_SHARE = 1e-2
ARCHS = ["qwen2-0.5b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-1.2b",
         "whisper-small", "qwen2-vl-72b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_smoke_config(request.param)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    pcfg = port_smoke_config(request.param)
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, SEQ, BATCH))
    # the frontends' stub inputs come in the compute dtype: widened to
    # f32 (exact) for numpy, and cast back by both packages
    batch = {k: (v.float().numpy() if torch.is_tensor(v)
                 and v.is_floating_point() else np.asarray(v))
             for k, v in family_batch(pcfg, src.batch(0), 0).items()}
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, pcfg, params, flat, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(pcfg, flat, batch):
    """(loss, aux, grads, products counted in the forward, in the
    backward) of the port's ``lm_loss``."""
    params = bridge.from_flat(flat)
    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]
    from repro_torch.optim import tree_map
    p = tree_map(alias, params)
    fwd, bwd = PT.DotsCounter(), PT.DotsCounter()
    with torch.enable_grad():
        with fwd:
            loss, m = PT.lm_loss(p, pcfg, _tb(batch))
        with bwd:
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), m["aux_loss"].detach(), grads, fwd, bwd


@pytest.fixture(scope="module")
def runs(model):
    """The port's loss and gradients under each policy, in the config's
    dtype, with the products counted."""
    _, pcfg, _, flat, batch = model
    assert pcfg.remat and pcfg.remat_policy == "nothing"
    return {pol: _loss_and_grads(pcfg.with_(remat_policy=pol), flat, batch)
            for pol in ("nothing", "dots")}


def test_dots_equals_nothing_bit_for_bit(runs):
    (ln, an, gn, _, _), (ld, ad, gd, _, _) = runs["nothing"], runs["dots"]
    assert torch.equal(ld, ln) and torch.equal(ad, an)
    assert len(gd) == len(gn)
    assert all(torch.equal(a, b) for a, b in zip(gd, gn))


def test_dots_recomputes_no_forward_product(runs):
    fwd_n, bwd_n = runs["nothing"][3:]
    fwd_d, bwd_d = runs["dots"][3:]
    assert fwd_d.grad_on == fwd_n.grad_on > 0      # the same forward
    assert bwd_n.grad_on > 0                       # "nothing" recomputes
    assert bwd_d.grad_on == 0                      # "dots" re-runs none
    assert bwd_d.grad_off == bwd_n.grad_off        # the same gradients


def test_dots_matches_the_reference_dots(model):
    cfg, pcfg, params, flat, batch = model
    cfg = cfg.with_(dtype="float32", remat_policy="dots")
    pcfg = pcfg.with_(dtype="float32", remat_policy="dots")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(params, jb)
    got, _, pg = pstep.value_and_grad(lambda p, b: PT.lm_loss(p, pcfg, b),
                                      bridge.from_flat(flat), _tb(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    jg = {k: np.asarray(v) for k, v in _flatten_with_paths(jg).items()}
    pg = bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg if not _zero_grad_leaf(cfg, k)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[cfg.family], (worst, errs[worst])
    for k in jg:
        if _zero_grad_leaf(cfg, k):
            ref_v = np.linalg.norm(jg[k.replace("wk/b", "wv/b")])
            for g in (pg[k], jg[k]):
                assert np.linalg.norm(g) <= ZERO_GRAD_SHARE * ref_v, k


def _zero_grad_leaf(cfg, k: str) -> bool:
    """whisper's self-attention K bias: softmax is shift-invariant along
    each query's keys, so its gradient is zero up to f32 noise in both
    packages and is held to a share of the V bias's, as
    ``test_torch_encdec.py`` holds it."""
    return (cfg.family == "encdec" and k.endswith("attn/wk/b")
            and "cross" not in k)


def test_unknown_remat_policy_raises():
    cfg = port_smoke_config("qwen2-0.5b").with_(remat_policy="everything")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticTokenSource(
        TokenDatasetSpec(cfg.vocab_size, 8, 1)).batch(0).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        PT.lm_loss(params, cfg, batch)


def _dryrun(arch, strategy, mesh):
    shape = InputShape("train_4k", 64, 4, "train")
    base = port_smoke_config(arch)
    return [dryrun.count_step(base.with_(remat_policy=pol), shape, strategy,
                              mesh) for pol in ("nothing", "dots")]


def test_dryrun_peak_under_dots_exceeds_nothing():
    n, d = _dryrun("qwen2-0.5b", "dp_tp", {"data": 1, "model": 1})
    assert d["peak_memory_per_device"] > n["peak_memory_per_device"]
    assert d["flops"] < n["flops"]
    assert d["argument_size"] == n["argument_size"]


def test_dryrun_dots_gathers_again_under_fsdp_tp():
    """qwen3-moe smoke under ``fsdp_tp`` at (2, 2): the same collectives
    in every group (the layer groups' weights all-gathered over ``data``
    in the recompute too), fewer FLOPs; its peak is not the layers'
    activations at this size, so it need only not fall."""
    n, d = _dryrun("qwen3-moe-30b-a3b", "fsdp_tp", {"data": 2, "model": 2})
    assert d["groups_counts"] == n["groups_counts"]
    assert d["collective_bytes"] == n["collective_bytes"]
    assert d["flops"] < n["flops"]
    assert d["peak_memory_per_device"] >= n["peak_memory_per_device"]


def test_dryrun_takes_the_train_steps_options():
    """``count_step`` passes ``loss_variant``, ``seq_chunk`` and
    ``microbatches`` to the train step, as the reference's hill-climb
    passes its ``step_kw`` (qwen2 smoke at B 8 x S 512, (1, 1), where
    the activations set the peak): the chunked loss counts its chunks'
    recompute (more FLOPs), two microbatches hold half the activations
    (a lower peak), the arguments stay, and the peak is named where the
    flash backward reaches it; an inference step refuses them."""
    from repro_torch.configs.base import SHAPES
    shape = InputShape("train_4k", 512, 8, "train")
    cfg = port_smoke_config("qwen2-0.5b")
    mesh = {"data": 1, "model": 1}
    plain = dryrun.count_step(cfg, shape, "dp_tp", mesh)
    chunked = dryrun.count_step(cfg, shape, "dp_tp", mesh,
                                loss_variant="chunked_ce", seq_chunk=16)
    micro = dryrun.count_step(cfg, shape, "dp_tp", mesh, microbatches=2)
    assert chunked["flops"] > plain["flops"]
    assert micro["peak_memory_per_device"] < plain["peak_memory_per_device"]
    assert plain["argument_size"] == chunked["argument_size"] \
        == micro["argument_size"]
    assert plain["peak_at"].startswith("flash_attention.py:")
    with pytest.raises(ValueError, match="train step's options"):
        dryrun.count_step(cfg, SHAPES["decode_32k"], "dp_tp", mesh,
                          microbatches=2)
