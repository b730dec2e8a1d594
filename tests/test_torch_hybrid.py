"""zamba2 (the hybrid family: mamba2 layers and one weight-shared
attention + MLP block after every ``hybrid_attn_every`` of them) on the
training path, the port against the reference on the same bridged
weights and the same numpy batches: the tree's layout, ``forward``,
``lm_loss`` / ``lm_loss_chunked``, gradients (the shared block's summed
over its applications by autograd, as ``jax.grad`` sums them), three
``make_train_step`` steps, remat, and the launcher.  The smoke config
has 5 layers: two groups of two mamba layers each followed by the shared
block, then one tail layer.

Tolerances, the mamba2 bounds (``test_torch_train.py``), and why:
- logits atol 1e-2 in bf16 (observed 7.2e-3: a group is one compiled
  scan step in the reference, whose bf16 roundings the port follows
  only in part, ROADMAP Queue 3), 1e-5 in f32 (the same algorithm;
  observed 9.8e-7);
- losses rtol 1e-3 in bf16 (observed 1.2e-5), 1e-5 in f32;
- gradients by each leaf's relative norm error: 2e-2 in bf16 (observed
  1.4e-2, on dt_bias), 1e-5 in f32 (observed 3.4e-6, on A_log);
- 3 train steps: losses rtol 1e-3 in bf16, 1e-5 in f32; params after
  them atol 2e-4 in f32, qwen2's bound (Adam divides each update by its
  gradient's running magnitude, so an element whose gradient is near 0
  amplifies f32 noise, up to lr a step; observed 1.6e-4 on one element
  of the embedding table, 2e-8 elsewhere);
- remat on against remat off, bf16: bit for bit (the recompute runs the
  same operations on the same inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ARCH = "zamba2-1.2b"
SEQ, BATCH = 24, 2
LOGIT_ATOL = {"bfloat16": 1e-2, "float32": 1e-5}
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-5}
GRAD_RTOL = {"bfloat16": 2e-2, "float32": 1e-5}
PARAMS_ATOL = 2e-4


def _flat_np(tree):
    from repro.checkpoint.ckpt import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def zamba():
    from repro.configs import get_smoke_config
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config as port_smoke_config
    cfg = get_smoke_config(ARCH)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    batch = SyntheticTokenSource(TokenDatasetSpec(
        cfg.vocab_size, SEQ, BATCH)).batch(0)
    return (cfg, port_smoke_config(ARCH), params,
            bridge.from_flat(_flat_np(params)), batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_hybrid_tree_layout(zamba):
    """The port's own init has the reference's keys and shapes: mamba
    leaves stacked (G, E, ...), the tail (R, ...), one unstacked shared
    layer; the f32 leaves stay f32 when the rest is held in bf16."""
    from repro_torch import bridge
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, _, _ = zamba
    ref = _flat_np(params)
    tree = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                          weight_dtype=torch.bfloat16)
    ours = bridge.to_flat(tree)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
    E, G, R = (cfg.hybrid_attn_every, cfg.num_layers // cfg.hybrid_attn_every,
               cfg.num_layers % cfg.hybrid_attn_every)
    assert (G, E, R) == (2, 2, 1)
    d = cfg.d_model
    assert ours["layers/mamba/in_proj/w"].shape[:3] == (G, E, d)
    assert ours["tail_layers/mamba/out_proj/w"].shape[0] == R
    assert ours["shared_attn/attn/wq/w"].shape == (
        d, cfg.num_heads, cfg.resolved_head_dim)
    for leaf in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
        assert tree["layers"]["mamba"][leaf].dtype == torch.float32
        assert tree["tail_layers"]["mamba"][leaf].dtype == torch.float32
    assert tree["shared_attn"]["ln1"]["scale"].dtype == torch.float32
    assert tree["shared_attn"]["mlp"]["wi"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_losses_match_reference(zamba, dtype):
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = zamba
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    jb, tb = _jb(batch), _tb(batch)
    want, _ = jax.jit(lambda p, b: T.forward(p, cfg, b))(params, jb)
    want_l, _ = jax.jit(lambda p, b: T.lm_loss(p, cfg, b))(params, jb)
    want_c, _ = jax.jit(lambda p, b: T.lm_loss_chunked(
        p, cfg, b, seq_chunk=8))(params, jb)
    with torch.no_grad():
        got, aux = PT.forward(pparams, pcfg, tb)
        last, _ = PT.forward(pparams, pcfg, tb, last_only=True)
        got_l, _ = PT.lm_loss(pparams, pcfg, tb)
        got_c, _ = PT.lm_loss_chunked(pparams, pcfg, tb, seq_chunk=8)
    assert got.shape == (BATCH, SEQ, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL[dtype], rtol=0)
    torch.testing.assert_close(last, got[:, -1:])
    for g, w in ((got_l, want_l), (got_c, want_c)):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grads_match_reference(zamba, dtype):
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.distributed import stepfn as pstep
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = zamba
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(params,
                                                          _jb(batch))
    got, _, pg = pstep.value_and_grad(
        lambda p, b: PT.lm_loss(p, pcfg, b), pparams, _tb(batch))
    np.testing.assert_allclose(float(got), float(want),
                               rtol=LOSS_RTOL[dtype])
    jg, pg = _flat_np(jg), bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[dtype], (worst, errs[worst])
    # the shared block's leaves carry the sum over its applications
    assert np.linalg.norm(pg["shared_attn/attn/wq/w"]) > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_steps_match_reference(dtype):
    """3 AdamW steps of the reference's ``make_train_step`` (``dp`` on a
    one-device host mesh) against the port's, from the same weights."""
    from repro import optim as jopt
    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro.distributed import stepfn as jstep
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch import optim as popt
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn as pstep
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    pcfg = port_smoke_config(ARCH).with_(dtype=dtype)
    B = 4
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, SEQ, B))
    jo = jopt.adamw(1e-3, clip_norm=1.0)
    step, _, _ = jstep.make_train_step(
        cfg, jo, make_host_mesh(), "dp", InputShape("t", SEQ, B, "train"))
    jp, js = params, jo.init(params)
    po = popt.adamw(1e-3, clip_norm=1.0)
    pp = bridge.from_flat(_flat_np(params))
    ps = po.init(pp)
    with hvd.init("cpu"):
        pstep_fn = pstep.make_train_step(
            pcfg, po, hvd.axis_groups({"data": 1}), device="cpu")
        for i in range(3):
            jp, js, jm = step(jp, js, _jb(src.batch(i)))
            pp, ps, pm = pstep_fn(pp, ps, src.batch(i))
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                       rtol=LOSS_RTOL[dtype])
            assert np.isfinite(float(pm["grad_norm"]))
    if dtype == "float32":
        jf, pf = _flat_np(jp), bridge.to_flat(pp)
        for k in jf:
            np.testing.assert_allclose(pf[k], jf[k], atol=PARAMS_ATOL,
                                       rtol=0, err_msg=k)


def test_remat_on_equals_remat_off(zamba):
    """Checkpointing each mamba layer and each application of the shared
    block, carrying the unrounded residual through them, changes neither
    the loss nor any gradient by a bit."""
    from repro_torch import bridge
    from repro_torch.distributed import stepfn as pstep
    from repro_torch.models import transformer as PT
    _, pcfg, _, pparams, batch = zamba
    got = {}
    for remat in (True, False):
        c = pcfg.with_(remat=remat)
        loss, _, g = pstep.value_and_grad(
            lambda p, b: PT.lm_loss(p, c, b), pparams, _tb(batch))
        got[remat] = (float(loss), bridge.to_flat(g))
    assert got[True][0] == got[False][0]
    for k, v in got[False][1].items():
        np.testing.assert_array_equal(got[True][1][k], v, err_msg=k)


def test_launcher_trains_zamba2_on_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "24",
                      "--global-batch", "2"])
    assert out["arch"] == "zamba2-1.2b-smoke"
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    # plain versions on the CPU: no kernel launches
    assert out["launches_per_step"] == {
        "flash_attention": [0, 0], "ssd_scan": [0, 0], "rmsnorm": [0, 0]}
