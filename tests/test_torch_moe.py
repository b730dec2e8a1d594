"""The MoE block (``repro_torch.models.moe``) and the moe family's steps:
the port against the reference on the same numpy inputs and the same
(bridged) weights.

- ``expert_capacity`` over a grid of sizes and ``_dispatch_indices``
  (expert, rank, keep) on random and heavily tied expert ids with
  capacity overflow: exactly equal;
- ``moe_block``'s output and aux loss in f32 and bf16, with token counts
  that are not a multiple of the group size or are prime, a zero router
  (uniform probabilities: the tie order picks experts 0..K-1) and a small
  capacity factor that drops tokens;
- ``prefill_step`` / ``decode_step`` logits at the qwen3-moe and dbrx
  smoke configs (paged, then dense decode), the init tree against the
  reference's layout, the router held in f32 by the bridge and by
  ``init_params``, the slice-by-slice draw reproducible;
- training: ``forward``'s aux loss (the layers' load-balance losses summed),
  ``lm_loss`` and ``lm_loss_chunked`` and their gradients through the
  dispatch at both smoke configs, in bf16 and f32, and the launcher;
- expert parallelism: ``moe_block`` with its experts split over a
  ``model`` group of 2 gloo ranks against the unsharded block (output,
  aux loss, the gradients of x, the router and every expert).

Tolerances: dispatch indices and capacities exact; ``moe_block`` in bf16
within one bf16 ulp of its largest |output| (2^-7 max |out|) and at least
99% of elements bit-equal (observed: one token's row of 64 apart in 4,096,
by 1-2 ulps, from one element of ``a(hg) * hi`` one ulp apart, the
reference's ``jax.nn.silu`` (``lax.logistic``) against the port's op-by-op
silu, carried through ``wo``), in f32 within 1e-6 (GEMMs summed in
another order) and the aux loss within 1e-6 relative; step
logits within atol 1e-2 (``test_torch_model.py``'s); training as
``test_torch_train.py`` holds the dense family: losses rtol 1e-3 in bf16
and 1e-5 in f32, the aux loss rtol 1e-3 / 1e-5, gradients by each leaf's
relative norm error within 3e-2 (bf16) and 1e-4 (f32); expert parallel
against unsharded in f32 within 1e-6 (the combine sums each rank's slots,
then the ranks: f32 sums in another order) and the aux loss exactly.  On
the card
(``gpu``): ``moe_block`` against the CPU plain path on the same weights
(bf16 within one ulp of the largest output, identical routing), and
``init_params`` on the card's generator reproducible and made without a
whole leaf in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.configs.base import ModelConfig
from repro.models import moe as M
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.configs.base import ModelConfig as PModelConfig
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

F32_ATOL = 1e-6
BF16_ULP = 2.0 ** -7
LOGIT_ATOL = 1e-2
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]


def _cfgs(**kw):
    base = dict(name="t", family="moe", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=11,
                num_experts=8, num_experts_per_tok=2, moe_group_size=16)
    base.update(kw)
    return ModelConfig(**base), PModelConfig(**base)


def _tree(p):
    return bridge.from_flat({k: np.asarray(v) for k, v in
                             _flatten_with_paths(p).items()})


# ---------------------------------------------------------------------------
# dispatch bookkeeping: exact
# ---------------------------------------------------------------------------

def test_expert_capacity_matches_reference_over_a_grid():
    for E in (1, 4, 8, 16, 128):
        for K in (1, 2, 4, 8):
            if K > E:
                continue
            for cf in (0.25, 0.5, 1.0, 1.25, 2.0, 3.3):
                c, pc = _cfgs(num_experts=E, num_experts_per_tok=K,
                              moe_capacity_factor=cf)
                for tpg in (1, 2, 7, 8, 13, 64, 100, 1000, 4096):
                    assert PM.expert_capacity(tpg, pc) == \
                        M.expert_capacity(tpg, c), (E, K, cf, tpg)


# jitted once per (T, K): the capacity is traced
_ref_dispatch = jax.jit(M._dispatch_indices)


def _dispatch_both(eidx: np.ndarray, capacity: int):
    ref = [np.asarray(a) for a in _ref_dispatch(
        jnp.asarray(eidx, jnp.int32), capacity)]
    got = [a.numpy() for a in PM._dispatch_indices(
        torch.from_numpy(eidx.astype(np.int64)), capacity)]
    return ref, got


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**30), T_=st.sampled_from([1, 5, 13, 40, 97]),
       K=st.sampled_from([1, 2, 4]), E=st.sampled_from([1, 2, 4, 16]),
       capacity=st.sampled_from([1, 2, 8, 16]),
       tied=st.booleans())
def test_dispatch_indices_equal_reference(seed, T_, K, E, capacity, tied):
    """Random ids, or heavily tied ones (most slots on one expert), with
    capacities that overflow: expert, rank and keep exactly equal."""
    rng = np.random.default_rng(seed)
    if tied:
        eidx = np.where(rng.random((T_, K)) < 0.8, E - 1,
                        rng.integers(0, E, (T_, K)))
    else:
        eidx = rng.integers(0, E, (T_, K))
    ref, got = _dispatch_both(eidx, capacity)
    for r, g, what in zip(ref, got, ("expert", "rank", "keep")):
        np.testing.assert_array_equal(g, r, err_msg=what)


def test_dispatch_indices_batched_groups_equal_reference_per_group():
    """The port takes every group at once (leading dims); each group's
    result equals the reference's single-group call."""
    rng = np.random.default_rng(4)
    eidx = rng.integers(0, 4, (3, 40, 2))
    eidx[1] = 2                                  # one group all on expert 2
    got = PM._dispatch_indices(torch.from_numpy(eidx), 8)
    for g in range(3):
        ref, _ = _dispatch_both(eidx[g], 8)
        for r, t in zip(ref, got):
            np.testing.assert_array_equal(t[g].numpy(), r)
    assert not got[2][1, 8:].any()               # overflow dropped


# ---------------------------------------------------------------------------
# moe_block against the reference
# ---------------------------------------------------------------------------

def _close(o, ro, dtype):
    if dtype == "bfloat16":
        np.testing.assert_allclose(o, ro, rtol=0,
                                   atol=BF16_ULP * np.abs(ro).max())
        assert (o == ro).mean() >= 0.99
    else:
        np.testing.assert_allclose(o, ro, atol=F32_ATOL, rtol=0)


def _block_both(c, pc, x: np.ndarray, params=None, seed=0):
    p = params if params is not None else M.init_moe(
        jax.random.PRNGKey(seed), c)
    ro, ra = jax.jit(lambda p, x: M.moe_block(p, c, x))(
        p, jnp.asarray(x).astype(c.dtype))
    tx = torch.from_numpy(x).to(getattr(torch, pc.dtype))
    o, a = PM.moe_block(_tree(p), pc, tx)
    return (np.asarray(ro.astype(jnp.float32)), float(ra),
            o.float().numpy(), float(a), o.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 13), (2, 23), (3, 7), (1, 64)],
                         ids=["T13", "T46", "T21", "T64"])
def test_moe_block_matches_reference(dtype, B, S):
    """Token counts prime (13) or not a multiple of the group size 16
    (46: groups of 2 tokens; 21: groups of 7), and 64 (four groups)."""
    c, pc = _cfgs(dtype=dtype)
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, c.d_model)).astype(np.float32)
    ro, ra, o, a, odt = _block_both(c, pc, x)
    assert odt == getattr(torch, dtype)
    _close(o, ro, dtype)
    np.testing.assert_allclose(a, ra, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_router_picks_the_lowest_experts(dtype):
    """A zero router gives every expert probability 1/E: the reference's
    ``lax.top_k`` takes experts 0..K-1, and so must the port."""
    c, pc = _cfgs(dtype=dtype, num_experts_per_tok=3)
    p = M.init_moe(jax.random.PRNGKey(1), c)
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    x = np.random.default_rng(2).standard_normal((2, 9, c.d_model)).astype(
        np.float32)
    tp = _tree(p)
    _, gate, eidx = PM.route(tp, pc, torch.from_numpy(x).reshape(1, 18, -1))
    assert (eidx == torch.arange(3)).all()
    np.testing.assert_allclose(gate.numpy(), 1.0 / 3.0, rtol=1e-7)
    ro, ra, o, a, _ = _block_both(c, pc, x, params=p)
    _close(o, ro, dtype)
    np.testing.assert_allclose(a, ra, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_capacity_drops_tokens_as_the_reference(dtype):
    """Capacity factor 0.25 over 64 tokens in one group: C = 8 slots an
    expert against 16 routed on average, so tokens drop (zero output where
    every choice of a token dropped)."""
    c, pc = _cfgs(dtype=dtype, moe_capacity_factor=0.25,
                  moe_group_size=4096)
    x = np.random.default_rng(6).standard_normal((1, 64, c.d_model)).astype(
        np.float32)
    ro, ra, o, a, _ = _block_both(c, pc, x, seed=3)
    _close(o, ro, dtype)
    np.testing.assert_allclose(a, ra, rtol=1e-6)
    assert PM.expert_capacity(64, pc) == 8
    dropped = (np.abs(ro).sum(axis=-1) == 0).sum()
    assert dropped > 0                           # the case drops whole tokens


def test_moe_block_reads_the_norm_output_rounded():
    """Inside a layer the block reads the norm's bf16 output (the router
    widens it to f32): the jitted reference norm + block and the port's
    norm + block agree bit for bit on bf16 inputs."""
    from repro.models import modules as RM
    from repro_torch.models import modules as PMod
    c, pc = _cfgs()
    p = M.init_moe(jax.random.PRNGKey(5), c)
    scale = np.random.default_rng(7).standard_normal(c.d_model).astype(
        np.float32) * 0.1
    x = np.random.default_rng(8).standard_normal((2, 11, c.d_model)).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def ref(p, s, x):
        return M.moe_block(p, c, RM.rmsnorm({"scale": s}, x, c.norm_eps))[0]

    ro = np.asarray(jax.jit(ref)(p, jnp.asarray(scale), xb).astype(
        jnp.float32))
    h = PMod.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x).bfloat16(), pc.norm_eps)
    o = PM.moe_block(_tree(p), pc, h)[0].float().numpy()
    np.testing.assert_array_equal(o, ro)


# ---------------------------------------------------------------------------
# whole steps and the parameter tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_smoke_config(request.param)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, port_smoke_config(request.param), params, \
        bridge.from_flat(flat, weight_dtype=torch.bfloat16), flat


def test_configs_equal_the_reference():
    from repro.configs import get_config
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.configs import get_config as port_config
    for arch in ARCHS:
        assert arch in PORT_ARCHS
        for ref, port in ((get_config(arch), port_config(arch)),
                          (get_smoke_config(arch), port_smoke_config(arch))):
            assert {k: v for k, v in vars(port).items()} == \
                {k: v for k, v in vars(ref).items()}
    assert port_config("qwen3-moe-30b-a3b").param_count() == 30_532_108_288


def test_init_tree_matches_reference_layout(model):
    """The port's init has the reference's leaves, shapes (experts stacked
    as (L, 1, E, ...)) and f32 router; the bridge keeps the router f32
    and narrows the experts."""
    cfg, pcfg, _, pparams, flat = model
    ours = bridge.to_flat(PT.init_params(pcfg, torch.Generator().manual_seed(
        0)))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in flat.items()}
    L, E = cfg.num_layers, cfg.num_experts
    assert flat["layers/moe/wi"].shape == (L, 1, E, cfg.d_model, cfg.d_ff)
    assert pparams["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert pparams["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert pparams["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    p = PT.init_params(pcfg, torch.Generator().manual_seed(0))
    assert p["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert p["layers"]["moe"]["wo"].dtype == torch.bfloat16
    # the stddevs of the reference's init (truncated at 2 sigma)
    w = p["layers"]["moe"]["wi"].float()
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 0.88) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6


def test_init_is_reproducible_and_dense_draws_unchanged():
    """A CPU generator gives the same weights for the same seed, every
    layer slice of a stacked leaf its own numbers, and a dense config's
    CPU draw is still one whole-leaf draw a leaf (the weights earlier
    seeds gave)."""
    pcfg = port_smoke_config("qwen3-moe-30b-a3b")
    a = bridge.to_flat(PT.init_params(pcfg, torch.Generator().manual_seed(3)))
    b = bridge.to_flat(PT.init_params(pcfg, torch.Generator().manual_seed(3)))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # every layer slice of a stacked leaf drawn apart
    wi = a["layers/moe/wi"]
    assert not np.array_equal(wi[0], wi[1])
    dense = port_smoke_config("qwen2-0.5b")
    g = torch.Generator().manual_seed(0)
    p = PT.init_params(dense, g)
    g2 = torch.Generator().manual_seed(0)
    first = torch.empty(p["layers"]["attn"]["wq"]["w"].shape)
    from repro_torch.models import modules as PMod
    PMod.truncated_normal_(first, 1.0 / np.sqrt(dense.d_model), g2)
    assert torch.equal(p["layers"]["attn"]["wq"]["w"],
                       first.to(torch.bfloat16))


def test_prefill_and_decode_logits_match_reference(model):
    cfg, pcfg, params, pparams, _ = model
    rng = np.random.default_rng(11)
    B, C, bs, nb = 3, 8, 8, 12
    shape = (cfg.num_layers, 1, nb + 1, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jc = {"layers": {n: jnp.zeros(shape, jnp.bfloat16) for n in "kv"}}
    tc = {"layers": {n: torch.zeros(shape, dtype=torch.bfloat16)
                     for n in "kv"}}
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, nb], [7, 8, 9, 10]], np.int32)
    starts = np.zeros(B, np.int32)
    for ql in (np.array([C, 5, 0], np.int32), np.array([C, 0, 3], np.int32)):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        jl, jc = jax.jit(T.prefill_step, static_argnums=1)(params, cfg, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
            "q_lens": jnp.asarray(ql), "cache": jc,
            "block_tables": jnp.asarray(tables)})
        tl, tc = PT.prefill_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(starts),
            "q_lens": torch.from_numpy(ql), "cache": tc,
            "block_tables": torch.from_numpy(tables)})
        for b in range(B):
            np.testing.assert_allclose(
                tl[b, :ql[b]].numpy(), np.asarray(jl[b, :ql[b]], np.float32),
                atol=LOGIT_ATOL, rtol=0)
        starts = starts + ql
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jax.jit(T.decode_step, static_argnums=1)(params, cfg, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
            "cache": jc, "block_tables": jnp.asarray(tables)})
        tl, tc = PT.decode_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(starts), "cache": tc,
            "block_tables": torch.from_numpy(tables)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL, rtol=0)
        starts = starts + 1


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_dense_decode_logits_match_reference(model, kv_dtype):
    """Eight decode steps over the per-slot cache (bf16 or int8)."""
    cfg, pcfg, params, pparams, _ = model
    cfg, pcfg = (c.with_(kv_cache_dtype=kv_dtype) for c in (cfg, pcfg))
    B, S = 2, 16
    jc = T.init_cache(cfg, B, S)
    tc = PT.init_cache(pcfg, B, S)
    rng = np.random.default_rng(12)
    step = jax.jit(T.decode_step, static_argnums=1)
    for i in range(8):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.array([i, i + 3], np.int32)
        jl, jc = step(params, cfg, {"tokens": jnp.asarray(toks),
                                    "positions": jnp.asarray(pos),
                                    "cache": jc})
        tl, tc = PT.decode_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos), "cache": tc})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL, rtol=0)


def test_training_the_moe_family_is_refused():
    """No longer refused: ``forward`` and the losses run the moe family
    (its aux loss in the loss) and the launcher trains it, under ``dp``
    (the ``--smoke`` default) and ``fsdp_tp``, with the same losses at
    world size 1."""
    from repro_torch.launch import train
    pcfg = port_smoke_config("qwen3-moe-30b-a3b")
    p = PT.init_params(pcfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    _, aux = PT.forward(p, pcfg, batch)
    for fn in (PT.lm_loss, PT.lm_loss_chunked):
        loss, m = fn(p, pcfg, batch)
        assert float(m["aux_loss"]) == float(aux) > 0.0
        assert float(loss) == pytest.approx(float(m["ce_loss"] + aux))
    argv = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--steps",
            "2", "--seq-len", "16", "--global-batch", "2", "--dtype",
            "float32"]
    dp = train.main(argv)
    fsdp = train.main(argv + ["--strategy", "fsdp_tp"])
    assert (dp["strategy"], fsdp["strategy"]) == ("dp", "fsdp_tp")
    assert np.isfinite(dp["losses"]).all()
    np.testing.assert_allclose(fsdp["losses"], dp["losses"], rtol=1e-5)


TRAIN_RTOL = {"bfloat16": dict(loss=1e-3, aux=1e-3, grad=3e-2),
              "float32": dict(loss=1e-5, aux=1e-5, grad=1e-4)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_losses_and_grads_match_reference(model, dtype):
    """``lm_loss`` (and ``lm_loss_chunked``) with the aux loss, and the
    gradient of every leaf through the router, the dispatch's
    ``index_add`` and the slots' gather, against ``jax.value_and_grad``
    of the reference's ``lm_loss`` on the same f32 weights and batch."""
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn as pstep
    cfg, pcfg, params, _, flat = model
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    batch = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 24,
                                                  2)).batch(0)
    (want, wm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pparams = bridge.from_flat(flat)
    got, gm, pg = pstep.value_and_grad(lambda p, b: PT.lm_loss(p, pcfg, b),
                                       pparams, tb)
    with torch.no_grad():
        got_c, _ = PT.lm_loss_chunked(pparams, pcfg, tb, seq_chunk=8)
    tol = TRAIN_RTOL[dtype]
    assert float(wm["aux_loss"]) > 0.0
    np.testing.assert_allclose(float(gm["aux_loss"]), float(wm["aux_loss"]),
                               rtol=tol["aux"])
    for g in (got, got_c):
        np.testing.assert_allclose(float(g), float(want), rtol=tol["loss"])
    jg = {k: np.asarray(v) for k, v in _flatten_with_paths(jg).items()}
    pg = bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], (worst, errs[worst])
    # the router learns from the gates and the aux loss
    assert np.linalg.norm(pg["layers/moe/router/w"]) > 0.0


EP_PROG = """
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hvd
from repro_torch.distributed import sharding as sh
from repro_torch.models import moe as PM
from repro_torch.models.modules import Shards
store, out = sys.argv[1], sys.argv[2]
cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=11,
                  num_experts=8, num_experts_per_tok=2, moe_group_size=16,
                  dtype="float32")
g = torch.Generator().manual_seed(0)
draw = lambda shape, std, f32=False: torch.randn(shape, generator=g) * std
full = PM.init_moe(cfg, draw)
x = torch.randn((2, 23, 64), generator=g)
dout = torch.randn((2, 23, 64), generator=g)
with hvd.init("cpu", init_method=store):
    groups = hvd.axis_groups({"model": int(os.environ["WORLD_SIZE"])})
    specs = {k: sh.param_spec("moe/" + k, tuple(v.shape), cfg,
                              "dp_tp", groups)
             for k, v in full.items() if k != "router"}
    specs["router"] = {"w": sh.param_spec("moe/router/w",
                                          (64, 8), cfg, "dp_tp", groups)}
    local = sh.shard(full, specs, groups)
    leaves = [t.requires_grad_(True) for t in
              (local["router"]["w"], local["wi"], local["wg"], local["wo"])]
    xs = x.clone().requires_grad_(True)
    o, aux = PM.moe_block(local, cfg, xs, Shards(specs, groups["model"]))
    grads = torch.autograd.grad((o * dout).sum() + aux, [xs] + leaves)
    calls = groups["model"].calls
    whole = sh.unshard({"wi": grads[2], "wg": grads[3], "wo": grads[4]},
                       {k: specs[k] for k in ("wi", "wg", "wo")}, groups)
    rank = groups["model"].rank
np.savez(os.path.join(out, f"ep{rank}.npz"), out=o.detach().numpy(),
         aux=aux.detach().numpy(), x=grads[0].numpy(),
         router=grads[1].numpy(), **{k: v.numpy() for k, v in whole.items()},
         calls=np.array(calls),
         spec_wi=np.array(str(specs["wi"])))
"""


def test_expert_parallel_block_matches_the_unsharded_block(tmp_path):
    """``moe_block`` with 8 experts over a ``model`` group of 2 (4 each),
    in f32, against the unsharded block on the same weights: output and
    aux loss, and the gradients of x, the router and the experts (the
    experts' gathered back whole); both ranks agree bit for bit."""
    from repro_torch.core import hvd
    hvd.run_ranks(EP_PROG, 2, tmp_path)
    got = [dict(np.load(tmp_path / f"ep{r}.npz")) for r in range(2)]
    assert str(got[0]["spec_wi"]) == "('model', None, None)"
    # one all_reduce of the combine forward, the split's all_gather and
    # the gates' all_reduce backward
    assert int(got[0]["calls"]) == 3
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    c, pc = _cfgs(dtype="float32")
    g = torch.Generator().manual_seed(0)
    draw = lambda shape, std, f32=False: torch.randn(shape, generator=g) * std
    full = PM.init_moe(pc, draw)
    x = torch.randn((2, 23, 64), generator=g).requires_grad_(True)
    dout = torch.randn((2, 23, 64), generator=g)
    leaves = [t.requires_grad_(True) for t in
              (full["router"]["w"], full["wi"], full["wg"], full["wo"])]
    o, aux = PM.moe_block(full, pc, x)
    want = torch.autograd.grad((o * dout).sum() + aux, [x] + leaves)
    assert float(got[0]["aux"]) == aux.item()
    np.testing.assert_allclose(got[0]["out"], o.detach().numpy(),
                               atol=F32_ATOL, rtol=0)
    for name, w in zip(("x", "router", "wi", "wg", "wo"), want):
        np.testing.assert_allclose(got[0][name], w.numpy(), atol=F32_ATOL,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_moe_block_equals_the_cpu_path(cuda, monkeypatch):
    """qwen3-moe's expert widths (d 2048, d_ff 768) at 16 experts, a
    decode batch and a prefill tile: identical routing and the output
    within one bf16 ulp of the largest |output| (GEMMs summed in another
    order on the card)."""
    pcfg = PModelConfig(name="t", family="moe", num_layers=1, d_model=2048,
                        num_heads=32, num_kv_heads=4, head_dim=128,
                        d_ff=768, vocab_size=11, num_experts=16,
                        num_experts_per_tok=8)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    p1 = PT._index(PT.init_params(pcfg, g)["layers"]["moe"], 0, 0)
    for T_ in (8, 64):
        x = torch.randn((1, T_, 2048), generator=g).bfloat16()
        want, aux = PM.moe_block(p1, pcfg, x)
        pc = {k: (v.to(cuda) if torch.is_tensor(v)
                  else {kk: vv.to(cuda) for kk, vv in v.items()})
              for k, v in p1.items()}
        got, aux_c = PM.moe_block(pc, pcfg, x.to(cuda))
        e_cpu = PM.route(p1, pcfg, x.reshape(1, T_, -1))[2]
        e_gpu = PM.route(pc, pcfg, x.to(cuda).reshape(1, T_, -1))[2]
        assert torch.equal(e_cpu, e_gpu.cpu())
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()
        assert abs(aux_c.item() - aux.item()) <= 1e-6 * abs(aux.item())


@pytest.mark.gpu
def test_cuda_init_on_the_card_generator(cuda):
    """``init_params`` with the card's generator: the same weights for the
    same seed, leaves made on the card in their dtype, the router f32,
    and no more device memory at peak than the leaves plus one layer
    slice in f32."""
    pcfg = port_smoke_config("qwen3-moe-30b-a3b").with_(
        d_model=512, d_ff=256, num_experts=32, num_layers=4)

    def make():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        p = PT.init_params(pcfg, torch.Generator(device=cuda).manual_seed(
            5), device=cuda)
        torch.cuda.synchronize()
        return p, torch.cuda.max_memory_allocated(cuda) - base, \
            torch.cuda.memory_allocated(cuda) - base

    a, peak, held = make()
    b, _, _ = make()
    fa_, fb = bridge.to_flat(a), bridge.to_flat(b)
    assert all(np.array_equal(fa_[k], fb[k]) for k in fa_)
    assert a["layers"]["moe"]["wi"].device.type == "cuda"
    assert a["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert a["layers"]["moe"]["router"]["w"].dtype == torch.float32
    slice_f32 = a["layers"]["moe"]["wi"][0].numel() * 4
    assert peak <= held + 2 * slice_f32 + (1 << 20)
