"""The training path: the port against the reference on the same (bridged)
weights and the same numpy batches — forward, losses, gradients,
optimizers, whole train steps, data, checkpoints, and the launcher.

Tolerances, and why:
- forward logits: atol 1e-2, as in ``test_torch_model.py`` (bf16 compute;
  observed ~3.5e-3 for qwen2 smoke and ~4.5e-3 for gemma2 smoke: the
  jitted reference and the eager port round to bf16 at different points).
- ``lm_loss`` / ``lm_loss_chunked``: rtol 1e-3 (a mean over B * (S - 1)
  token losses of those logits).
- gradients, by each leaf's relative norm error: 3e-2 in bf16 (the logit
  gap above carries into every leaf; observed up to 1.4e-2, on qwen2's
  QKV biases), 1e-4 with the config's dtype set to float32 (the same
  algorithm without bf16 rounding: only f32 summation order differs;
  observed 2.2e-6).  mamba2 (ssm family): logits observed 2.5e-3 in
  bf16 and 5.7e-7 in f32; gradients held at 2e-2 in bf16 (observed
  8.4e-3, on dt_bias) and 1e-5 in f32 (observed 9.6e-7).
- optimizers: atol 1e-6 on f32 params after 3 updates (f32 elementwise
  math; the global norm sums the same leaves in the same order).
- 3 train steps: losses rtol 1e-3 in bf16; in float32 losses rtol 1e-5
  and params atol 2e-4 (Adam divides each update by its gradient's
  running magnitude, so elements whose gradient is near 0 amplify f32
  noise, up to lr per step; observed 4.5e-5).
- data and checkpoints: bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import ckpt as jck
from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.data import SyntheticTokenSource as JSource
from repro.data import TokenDatasetSpec as JSpec
from repro.distributed import stepfn as jstep
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch import optim as popt
from repro_torch.checkpoint import ckpt as pck
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.core import hvd
from repro_torch.data import SyntheticTokenSource as PSource
from repro_torch.data import TokenDatasetSpec as PSpec
from repro_torch.distributed import stepfn as pstep
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

LOGIT_ATOL = 1e-2
LOSS_RTOL = 1e-3
GRAD_RTOL = {"dense": {"bfloat16": 3e-2, "float32": 1e-4},
             "ssm": {"bfloat16": 2e-2, "float32": 1e-5}}
OPT_ATOL = 1e-6
SEQ, BATCH = 24, 2


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module",
                params=["qwen2-0.5b", "gemma2-2b", "mamba2-1.3b"])
def model(request):
    cfg = get_smoke_config(request.param)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    batch = JSource(JSpec(cfg.vocab_size, SEQ, BATCH)).batch(0)
    return (cfg, port_smoke_config(request.param), params,
            bridge.from_flat(_flat_np(params)), batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_logits_match_reference(model):
    cfg, pcfg, params, pparams, batch = model
    want, _ = jax.jit(lambda p, b: T.forward(p, cfg, b))(params, _jb(batch))
    with torch.no_grad():
        got, aux = PT.forward(pparams, pcfg, _tb(batch))
        last, _ = PT.forward(pparams, pcfg, _tb(batch), last_only=True)
        hidden, _ = PT.forward(pparams, pcfg, _tb(batch),
                               return_hidden=True)
    assert got.shape == (BATCH, SEQ, cfg.vocab_size)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    torch.testing.assert_close(last, got[:, -1:])
    assert hidden.shape == (BATCH, SEQ, cfg.d_model)


def test_losses_match_reference(model):
    cfg, pcfg, params, pparams, batch = model
    jb, tb = _jb(batch), _tb(batch)
    want, wm = jax.jit(lambda p, b: T.lm_loss(p, cfg, b))(params, jb)
    want_c, _ = jax.jit(lambda p, b: T.lm_loss_chunked(
        p, cfg, b, seq_chunk=8))(params, jb)
    with torch.no_grad():
        got, gm = PT.lm_loss(pparams, pcfg, tb)
        got_c, _ = PT.lm_loss_chunked(pparams, pcfg, tb, seq_chunk=8)
    for g, w in ((got, want), (got_c, want_c), (gm["perplexity"],
                                                 wm["perplexity"])):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
    # the chunked loss is the same function (SEQ - 1 = 23: a ragged chunk)
    np.testing.assert_allclose(float(got_c), float(got), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grads_match_reference(model, dtype):
    cfg, pcfg, params, pparams, batch = model
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(params,
                                                          _jb(batch))
    got, _, pg = pstep.value_and_grad(
        lambda p, b: PT.lm_loss(p, pcfg, b), pparams, _tb(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    jg, pg = _flat_np(jg), bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[cfg.family][dtype], (worst, errs[worst])


OPTIMIZERS = [
    ("sgd", dict(clip_norm=0.5)),
    ("sgd", dict(momentum=0.9)),
    ("rmsprop", dict(clip_norm=0.5)),
    ("adam", dict(clip_norm=0.5)),
    ("adamw", dict(weight_decay=0.1, clip_norm=0.5)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in OPTIMIZERS])
def test_optimizers_match_reference(name, kw):
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((5, 3))},
              "b": rng.standard_normal((7,)), "c": rng.standard_normal(())}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    grads = [jax.tree.map(lambda a: np.asarray(
        rng.standard_normal(a.shape) * 0.7, np.float32), params)
        for _ in range(3)]
    sched = jopt.schedules.warmup_cosine(1e-2, 1, 3)
    jo = jopt.get(name, sched, **kw)
    po = popt.get(name, popt.schedules.warmup_cosine(1e-2, 1, 3), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    pp = jax.tree.map(torch.from_numpy, params)
    js, ps = jo.init(jp), po.init(pp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        pu, ps = po.update(jax.tree.map(torch.from_numpy, g), ps, pp)
        pp = popt.apply_updates(pp, pu)
        jf, pf = _flat_np(jp), bridge.to_flat(pp)
        for k in jf:
            np.testing.assert_allclose(pf[k], jf[k], atol=OPT_ATOL, rtol=0)
    # the same state layout, so optimizer checkpoints cross packages
    jsf, psf = _flat_np(js), pck._flatten_with_paths(ps)
    assert list(jsf) == list(psf)
    for k in jsf:
        assert psf[k].dtype == getattr(torch, str(jsf[k].dtype))
        np.testing.assert_allclose(psf[k].numpy(), jsf[k], atol=OPT_ATOL)
    assert int(ps["count"]) == 3
    np.testing.assert_allclose(float(popt.global_norm(pp)),
                               float(jopt.global_norm(jp)), rtol=1e-6)


def _train_steps_vs_reference(arch, dtype, microbatches, params_atol):
    """3 steps of the reference's ``stepfn.make_train_step`` (``dp`` on a
    one-device host mesh) against the port's, AdamW with clipping; losses
    at every step, and the params after them in f32."""
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    pcfg = port_smoke_config(arch).with_(dtype=dtype)
    B = 4
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat0 = _flat_np(params)
    src = JSource(JSpec(cfg.vocab_size, SEQ, B))
    jo = jopt.adamw(1e-3, clip_norm=1.0)
    step, _, _ = jstep.make_train_step(
        cfg, jo, make_host_mesh(), "dp", InputShape("t", SEQ, B, "train"),
        microbatches=microbatches)
    jp, js = params, jo.init(params)
    po = popt.adamw(1e-3, clip_norm=1.0)
    pp = bridge.from_flat(flat0)
    ps = po.init(pp)
    with hvd.init("cpu"):
        pstep_fn = pstep.make_train_step(
            pcfg, po, hvd.axis_groups({"data": 1}),
            microbatches=microbatches, device="cpu")
        for i in range(3):
            jp, js, jm = step(jp, js, _jb(src.batch(i)))
            pp, ps, pm = pstep_fn(pp, ps, src.batch(i))
            rtol = LOSS_RTOL if dtype == "bfloat16" else 1e-5
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                       rtol=rtol)
            assert np.isfinite(float(pm["grad_norm"]))
    assert int(ps["count"]) == 3
    if dtype == "float32":
        jf, pf = _flat_np(jp), bridge.to_flat(pp)
        for k in jf:
            np.testing.assert_allclose(pf[k], jf[k], atol=params_atol,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype,microbatches", [
    ("bfloat16", 1), ("bfloat16", 2), ("float32", 1), ("float32", 2)])
def test_train_steps_match_reference(dtype, microbatches):
    """qwen2 smoke: 3 train steps against the reference's."""
    _train_steps_vs_reference("qwen2-0.5b", dtype, microbatches, 2e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_train_steps_match_reference(dtype):
    """mamba2 smoke: 3 train steps against the reference's; params in f32
    at atol 5e-5 (observed 1.9e-5; losses observed 8.9e-8 relative in f32
    and 6.2e-5 in bf16)."""
    _train_steps_vs_reference("mamba2-1.3b", dtype, 1, 5e-5)


def test_data_sources_match_reference():
    spec = dict(vocab_size=307, seq_len=33, global_batch=6, seed=5,
                noise=0.4)
    for rank, world in ((0, 1), (1, 3)):
        js = JSource(JSpec(**spec), rank=rank, world_size=world)
        ps = PSource(PSpec(**spec), rank=rank, world_size=world)
        for step, epoch in ((0, 0), (3, 0), (2, 1)):
            jb, pb = js.batch(step, epoch), ps.batch(step, epoch)
            assert set(jb) == set(pb)
            for k in jb:
                assert pb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(pb[k], jb[k])
    with pytest.raises(ValueError):
        PSource(PSpec(**spec), world_size=4)


def _like_dtype(like, key):
    node = like
    for part in key.split("/"):
        node = node[part]
    return node.dtype


def test_checkpoints_cross_packages(tmp_path):
    cfg = get_smoke_config("qwen2-0.5b")
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(1))
    jo = jopt.adamw(1e-3)
    tree = {"params": params, "opt": jo.init(params)}
    # reference -> port
    jck.save(tmp_path / "j", 7, tree, extra={"note": "ref"})
    pp = bridge.from_flat(_flat_np(params))
    like = {"params": pp, "opt": popt.adamw(1e-3).init(pp)}
    assert pck.latest_step(tmp_path / "j") == 7
    got = pck.restore(tmp_path / "j", like)
    want = _flat_np(tree)
    for k, v in pck._flatten_with_paths(got).items():
        assert v.dtype == _like_dtype(like, k)
        np.testing.assert_array_equal(v.numpy(), want[k])
    # port -> reference, after changing every leaf (bf16 leaves included)
    moved = popt.tree_map(lambda t: t + 1, got)
    moved["params"]["embed"]["table"] = moved["params"]["embed"][
        "table"].to(torch.bfloat16)
    pck.save(tmp_path / "p", 9, moved, extra={"note": "port"})
    assert jck.latest_step(tmp_path / "p") == 9
    jlike = jax.tree.map(lambda a: a, tree)
    jlike["params"]["embed"]["table"] = jlike["params"]["embed"][
        "table"].astype(jnp.bfloat16)
    back = _flat_np(jck.restore(tmp_path / "p", jlike))
    for k, v in pck._flatten_with_paths(moved).items():
        np.testing.assert_array_equal(back[k].astype(np.float32),
                                      v.float().numpy())
    assert jck.manifest(tmp_path / "p")["leaves"][
        "params/embed/table"]["dtype"] == "bfloat16"
    assert pck.manifest(tmp_path / "j") == jck.manifest(tmp_path / "j")
    # rotation keeps the newest ``keep``
    for s in (10, 11, 12):
        pck.save(tmp_path / "p", s, moved, keep=2)
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "step_000000011", "step_000000012"]


def test_train_launcher_on_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16",
                      "--global-batch", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    # plain versions on the CPU: no kernel launches
    assert out["launches_per_step"] == {
        "flash_attention": [0, 0], "ssd_scan": [0, 0], "rmsnorm": [0, 0]}
    assert out["strategy"] == "dp" and out["mesh"] == {"data": 1,
                                                       "model": 1}
    # the sharded strategies run on the host mesh's model axis of size 1:
    # the same losses as dp up to the vocab-parallel cross-entropy's
    # arithmetic (a max and a sum of exponentials for log_softmax's)
    for strategy in ("dp_tp", "fsdp_tp"):
        sharded = train.main(["--arch", "gemma2-2b", "--smoke", "--device",
                              "cpu", "--steps", "2", "--seq-len", "16",
                              "--global-batch", "2", "--strategy", strategy])
        assert sharded["strategy"] == strategy
        np.testing.assert_allclose(sharded["losses"], out["losses"],
                                   rtol=LOSS_RTOL)
        assert all(c["calls"] > 0 for c in
                   sharded["model_collectives_per_step"])


def test_mamba2_launcher_on_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "40",
                      "--global-batch", "2"])
    assert out["arch"] == "mamba2-1.3b-smoke"
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert set(out["launches_per_step"]) == {"flash_attention", "ssd_scan",
                                             "rmsnorm"}


def test_train_launcher_defaults_to_cuda_and_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is for "
                    "machines without one")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
