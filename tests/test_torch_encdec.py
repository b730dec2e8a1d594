"""The encdec family (whisper-small smoke: a bidirectional encoder over
stub frame embeddings, a causal decoder with cross-attention, LayerNorm,
GELU, learned positions), the port against the reference on the same
bridged weights and the same numpy inputs: the tree, ``layernorm``,
``_encode``, ``attention_block`` with ``kv_override``, ``forward``, the
two losses, gradients against ``jax.grad``, ``decode_step`` with
``encoder_output`` (bf16 and int8 caches), greedy tokens through
``Scheduler`` against the reference engine's, the refusals the reference
makes (paged mode, the prefix store, the serve launcher), the train
launcher, and remat.

Tolerances, and why:
- f32 outputs (norms, the encoder, cross-attention, logits) atol 1e-5:
  the same algorithm, sums in another order (observed ~6e-7 on logits);
- bf16 LayerNorm within one bf16 ulp element by element (rtol 8e-3);
  cross-attention, a sum over every frame, within one ulp of its largest
  |output| (2^-7 max |out|, as the MoE block; element by element 7 of
  1,280 values near 0 differ by more than 1%, by 2.4e-4 at most); the
  encoder within two ulps of its largest |output|: its attention is
  bidirectional, so a one-ulp flip in the first layer reaches every row of
  the second (31% of the smoke encoder's outputs differ, by at most 2^-5
  at max |out| 3.7, after its final LayerNorm); bf16 logits atol 1e-2,
  the earlier slices' bound (observed 6.2e-3);
- losses rtol 1e-5 in f32, 1e-3 in bf16 (observed 4.8e-5);
- gradients by each leaf's relative norm error, 1e-5 in f32 and 3e-2 in
  bf16 (the dense family's bounds; observed 1.3e-6 and 1.5e-2), except
  the self-attention K biases: without RoPE a key bias adds q . b to every
  score of a query alike, which the softmax cancels, so their gradient is
  0 and both packages return rounding noise; each is held below 1e-2 of
  the V bias's gradient norm instead;
- decode logits atol 1e-2 at every step (bf16 and int8), as the dense
  family's dense decode;
- greedy tokens identical at the engines' tie-eps 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ARCH = "whisper-small"
SEQ, BATCH = 24, 2
F32_ATOL = 1e-5
BF16_RTOL = 8e-3
LOGIT_ATOL = {"bfloat16": 1e-2, "float32": 1e-5}
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-5}
GRAD_RTOL = {"bfloat16": 3e-2, "float32": 1e-5}
ZERO_GRAD_SHARE = 1e-2
TIE_EPS = 1e-2


def _flat_np(tree):
    from repro.checkpoint.ckpt import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def whisper():
    from repro.configs import get_smoke_config
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config as port_smoke_config
    cfg = get_smoke_config(ARCH)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {
        "encoder_input": rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                               dtype=np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                               dtype=np.int32)}
    return (cfg, port_smoke_config(ARCH), params,
            bridge.from_flat(_flat_np(params)), batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, dtype, ulps=0):
    """f32 within F32_ATOL; bf16 within one ulp element by element, or
    with ``ulps`` within that many ulps of the largest |output| (``ulps``
    x 2^-7 max |want|), for outputs that are sums over many keys."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0)
    elif ulps:
        assert np.abs(g - w).max() <= ulps * 2.0 ** -7 * np.abs(w).max()
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-6)


def test_encdec_tree_layout(whisper):
    """The port's own init has the reference's keys and shapes: the
    encoder subtree (layers stacked (E, ...), its final norm and
    positions), decoder layers stacked (L, ...) with ``ln_cross`` and a
    bias-free ``cross_attn``, the learned positions; LayerNorm's scale
    (ones) and bias (zeros) stay f32 when the rest is held in bf16, and
    the bridge keeps the bias f32."""
    from repro_torch import bridge
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, _ = whisper
    ref = _flat_np(params)
    tree = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                          weight_dtype=torch.bfloat16)
    ours = bridge.to_flat(tree)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
    L, E, d = cfg.num_layers, cfg.encoder_layers, cfg.d_model
    assert ours["encoder/layers/attn/wq/w"].shape[0] == E
    assert ours["layers/cross_attn/wk/w"].shape[0] == L
    assert "layers/cross_attn/wq/b" not in ours
    assert "layers/attn/wq/b" in ours
    assert ours["pos_embed"].shape == (cfg.max_pos_embed, d)
    assert ours["encoder/pos_embed"].shape == (cfg.encoder_seq, d)
    for norm in (tree["final_norm"], tree["layers"]["ln_cross"],
                 tree["encoder"]["layers"]["ln1"]):
        assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
        assert bool((norm["scale"] == 1).all() and (norm["bias"] == 0).all())
    assert tree["layers"]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    narrowed = bridge.from_flat(ref, weight_dtype=torch.bfloat16)
    assert narrowed["layers"]["ln2"]["bias"].dtype == torch.float32
    assert narrowed["layers"]["attn"]["wq"]["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    from repro.models import modules as M
    from repro_torch.models import modules as PM
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((4, 7, 96)) + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(96)).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = M.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x).astype(jdt), 1e-6)
    got = PM.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(whisper, dtype):
    """``_encode``: frames plus the encoder's positions, its
    bidirectional layers and final norm."""
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = whisper
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    want = jax.jit(lambda p, x: T._encode(p["encoder"], cfg, x))(
        params, jnp.asarray(batch["encoder_input"]))
    with torch.no_grad():
        got = PT._encode(pparams["encoder"], pcfg,
                         torch.from_numpy(batch["encoder_input"]))
    assert got.shape == (BATCH, cfg.encoder_seq, cfg.d_model)
    _close(got, want, dtype, ulps=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(whisper, dtype):
    """``attention_block`` with ``kv_override``: K/V from the encoder
    output, no RoPE, no mask, the cache untouched (decode passes one)."""
    from repro.models import attention as A
    from repro_torch.models import attention as PA
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = whisper
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BATCH, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((BATCH, cfg.encoder_seq,
                               cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], params["layers"])["cross_attn"]
    want, _ = A.attention_block(lp, cfg, jnp.asarray(x).astype(
        jnp.dtype(dtype)), kv_override=jnp.asarray(enc), use_rope=False)
    plp = PT._index(pparams["layers"], 1)["cross_attn"]
    with torch.no_grad():
        got, cache = PA.attention_block(
            plp, pcfg, torch.from_numpy(x).to(getattr(torch, dtype)),
            kv_override=torch.from_numpy(enc), use_rope=False)
    assert cache is None
    _close(got, want, dtype, ulps=1)
    # every query sees every key: the first query moves with the last key
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    with torch.no_grad():
        moved, _ = PA.attention_block(
            plp, pcfg, torch.from_numpy(x).to(getattr(torch, dtype)),
            kv_override=torch.from_numpy(enc2), use_rope=False)
    assert not torch.equal(moved[:, 0], got[:, 0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_losses_match_reference(whisper, dtype):
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = whisper
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


def _zero_grad_leaf(k: str) -> bool:
    return k.endswith("attn/wk/b") and "cross" not in k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grads_match_reference(whisper, dtype):
    from repro import optim  # noqa: F401  (the reference's tree helpers)
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.distributed import stepfn
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = whisper
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(params,
                                                          _jb(batch))
    got, _, pg = stepfn.value_and_grad(
        lambda p, b: PT.lm_loss(p, pcfg, b), pparams, _tb(batch))
    np.testing.assert_allclose(float(got), float(want),
                               rtol=LOSS_RTOL[dtype])
    jg, pg = _flat_np(jg), bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg if not _zero_grad_leaf(k)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[dtype], (worst, errs[worst])
    zeros = [k for k in jg if _zero_grad_leaf(k)]
    assert sorted(zeros) == ["encoder/layers/attn/wk/b", "layers/attn/wk/b"]
    for k in zeros:
        ref_v = np.linalg.norm(jg[k.replace("wk/b", "wv/b")])
        for g in (pg[k], jg[k]):
            assert np.linalg.norm(g) <= ZERO_GRAD_SHARE * ref_v, k


def test_remat_is_bitwise(whisper):
    """remat on (every encoder and decoder layer recomputed in the
    backward) against remat off, bf16: the same loss and gradients, bit
    for bit."""
    from repro_torch.distributed import stepfn
    from repro_torch.models import transformer as PT
    from repro_torch.optim import tree_map
    _, pcfg, _, pparams, batch = whisper
    out = []
    for remat in (True, False):
        c = pcfg.with_(remat=remat)
        out.append(stepfn.value_and_grad(
            lambda p, b: PT.lm_loss(p, c, b), pparams, _tb(batch)))
    assert torch.equal(out[0][0], out[1][0])
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             out[0][2], out[1][2])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_decode_steps_match_reference(whisper, kv_dtype):
    """Eight ``decode_step``s with ``encoder_output`` (each row its own
    encoder output) from position 0, bf16: the cache tree has the
    reference's leaves, shapes and dtypes ((L, B, S, KV, D), no layer
    groups), the logits stay within 1e-2 at every step, and every leaf
    is updated in place."""
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    from repro_torch.serving.kvcache import _leaves
    cfg, pcfg, params, pparams, batch = whisper
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    B, S = BATCH, 8
    enc_j = jax.jit(lambda p, x: T._encode(p["encoder"], cfg, x))(
        params, jnp.asarray(batch["encoder_input"]))
    with torch.no_grad():
        enc_t = PT._encode(pparams["encoder"], pcfg,
                           torch.from_numpy(batch["encoder_input"]))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jc = T.init_cache(cfg, B, S + 4)
    tc = PT.init_cache(pcfg, B, S + 4)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc["layers"].items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jc["layers"].items()}
    assert tc["layers"]["k"].shape[:3] == (cfg.num_layers, B, S + 4)
    ptrs = [t.data_ptr() for _, t in _leaves(tc)]
    step = jax.jit(T.decode_step, static_argnums=1)
    worst = 0.0
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jc = step(params, cfg, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.asarray(pos), "cache": jc,
            "encoder_output": enc_j})
        tl, tc = PT.decode_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "positions": torch.from_numpy(pos), "cache": tc,
            "encoder_output": enc_t})
        assert tl.shape == (B, 1, cfg.vocab_size)
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert worst <= LOGIT_ATOL["bfloat16"], worst
    assert [t.data_ptr() for _, t in _leaves(tc)] == ptrs


def test_decode_matches_forward(whisper):
    """Teacher-forced ``decode_step`` from an empty cache reproduces the
    port's ``forward`` logits in f32, within the reference's own bound
    for this check (2e-3: the decode cache holds K/V in bf16) and on its
    inputs (frames of std 0.1, 8 tokens)."""
    from repro_torch.models import transformer as PT
    _, pcfg, _, pparams, batch = whisper
    pcfg = pcfg.with_(dtype="float32")
    tb = {"tokens": _tb(batch)["tokens"][:, :8],
          "encoder_input": 0.1 * _tb(batch)["encoder_input"]}
    S = 8
    with torch.no_grad():
        want, _ = PT.forward(pparams, pcfg, tb)
        enc = PT._encode(pparams["encoder"], pcfg, tb["encoder_input"])
    cache = PT.init_cache(pcfg, BATCH, S + 4)
    got = []
    for t in range(S):
        lg, _ = PT.decode_step(pparams, pcfg, {
            "tokens": tb["tokens"][:, t:t + 1],
            "positions": torch.full((BATCH,), t, dtype=torch.int32),
            "cache": cache, "encoder_output": enc})
        got.append(lg)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want.numpy(),
                               atol=2e-3, rtol=0)


def _requests(cfg, req_cls, sp_cls, scale=1.0):
    rng = np.random.default_rng(4)
    lens, new = (4, 1, 7, 4, 2), (6, 5, 3, 7, 4)
    return [req_cls(rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
                    sp_cls(max_new_tokens=m, greedy=True),
                    encoder_input=(scale * rng.standard_normal(
                        (cfg.encoder_seq, cfg.d_model))).astype(np.float32))
            for n, m in zip(lens, new)]


def _serve(engine_cls, sched_cls, reqs, cfg, params, engine_kw):
    eng = engine_cls(cfg, params, **engine_kw)
    sched = sched_cls(eng, prefill_token_budget=8)
    rids = [sched.submit(r) for r in reqs]
    sched.run()
    return [sched.output(r).tolist() for r in rids], sched


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_scheduler_greedy_tokens_match_reference(whisper, kv_dtype):
    """Five requests, each with its own frames, through ``Scheduler`` at
    tie-eps 1e-2 in dense mode (budgeted prefill, 3 slots, so requests
    wait and slots are reused; prefix blocks asked for): the greedy
    tokens and every counter equal the reference engine's, no prefix
    store in either, nothing leaks."""
    from repro.serving import Request as RefRequest
    from repro.serving import SamplingParams as RefSP
    from repro.serving import Scheduler as RefScheduler
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg, pcfg, params, pparams, _ = whisper
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    kw = dict(max_seq_len=24, max_slots=3, kv_block_size=8, prefill_chunk=8,
              prefix_cache_blocks=8, greedy_tie_eps=TIE_EPS)
    ref, ref_sched = _serve(RefEngine, RefScheduler,
                            _requests(cfg, RefRequest, RefSP), cfg, params,
                            kw)
    ours, sched = _serve(ServingEngine, Scheduler,
                         _requests(cfg, Request, SamplingParams), pcfg,
                         pparams, dict(kw, device="cpu"))
    eng, ref_eng = sched.engine, ref_sched.engine
    assert ours == ref
    assert [len(o) for o in ours] == [6, 5, 3, 7, 4]
    assert eng.prefix_cache is None and ref_eng.prefix_cache is None
    for counter in ("decode_steps", "prefill_tokens",
                    "prefill_tokens_executed", "prefill_tokens_padding",
                    "cached_prefix_tokens"):
        assert getattr(eng, counter) == getattr(ref_eng, counter), counter
    kv = eng.kv
    assert not (sched.queue or sched.active or sched.prefilling)
    assert kv.free_slot_count == kv.max_slots and kv.pool.in_use == 0
    assert not eng._inflight
    assert sorted(eng.programs) == ["decode_step", "prefill_chunk"]


def test_other_frames_give_other_tokens(whisper):
    """The encoder matters: the same prompts with other frames decode to
    other tokens (the reference's ``test_serving_engine_encdec_whisper``)."""
    from repro_torch.serving import Request, SamplingParams, ServingEngine
    _, pcfg, _, pparams, _ = whisper
    eng = ServingEngine(pcfg, pparams, max_seq_len=24, max_slots=3,
                        device="cpu")
    outs = eng.generate(_requests(pcfg, Request, SamplingParams))
    outs2 = eng.generate(_requests(pcfg, Request, SamplingParams, scale=3.0))
    assert all(len(a) == len(b) for a, b in zip(outs, outs2))
    assert not all(np.array_equal(a, b) for a, b in zip(outs, outs2))
    with pytest.raises(ValueError, match="encoder_input"):
        eng.prefill_into_slot(np.array([1], np.int32))


def test_paged_mode_prefix_store_and_launcher_refused(whisper):
    """As the reference: paged storage and the prefix store raise its
    ``ValueError`` for encdec, the engine keeps no prefix store, paged
    ``prefill_step`` / ``decode_step`` raise, and the serve launcher exits
    with the reference's words."""
    from repro.serving.kvcache import PagedKVCache as RefKV
    from repro_torch.launch import serve
    from repro_torch.models import transformer as PT
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.kvcache import PagedKVCache
    cfg, pcfg, _, pparams, _ = whisper
    paged_msg = ("family 'encdec' has a non-positional decode cache; "
                 "paged attention unsupported")
    prefix_msg = ("family 'encdec' has a non-positional decode cache; "
                  "prefix caching unsupported")
    for kv_cls, c, kw in ((RefKV, cfg, {}), (PagedKVCache, pcfg,
                                             {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            kv_cls(c, 2, 32, block_size=8, paged=True, **kw)
        assert str(e.value) == paged_msg
        with pytest.raises(ValueError) as e:
            kv_cls(c, 2, 32, block_size=8, prefix_blocks=4, **kw)
        assert str(e.value) == prefix_msg
    with pytest.raises(ValueError, match="non-positional"):
        ServingEngine(pcfg, pparams, max_seq_len=32, paged=True,
                      device="cpu")
    eng = ServingEngine(pcfg, pparams, max_seq_len=32, max_slots=2,
                        prefix_cache_blocks=32, device="cpu")
    assert eng.prefix_cache is None and not eng.kv.supports_prefix_cache
    one = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="positional"):
        PT.prefill_step(pparams, pcfg, {
            "tokens": one, "positions": one[:, 0], "q_lens": one[:, 0] + 4,
            "cache": eng.kv.cache, "block_tables": one})
    with pytest.raises(ValueError, match="positional"):
        PT.decode_step(pparams, pcfg, {
            "tokens": one[:, :1], "positions": one[:, 0],
            "cache": eng.kv.cache, "block_tables": one})
    with pytest.raises(SystemExit, match="serve launcher targets decoder"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_train_launcher_on_cpu():
    """The launcher trains whisper smoke on the reference's batch: the
    source's tokens and labels beside (B, encoder_seq, d) frames from
    ``synthesize_inputs``; plain versions on the CPU, no launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape, input_specs
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.launch import train
    cfg = get_smoke_config(ARCH)
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 16, 2))
    b = train.family_batch(cfg, src.batch(3), 3)
    specs = input_specs(cfg, InputShape("t", 16, 2, "train"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()
            if k == "encoder_input"} == {"encoder_input": specs[
                "encoder_input"]}
    assert {k: tuple(np.shape(v)) for k, v in b.items()} == {
        k: s for k, (s, _) in specs.items()}
    np.testing.assert_array_equal(b["tokens"], src.batch(3)["tokens"])
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16",
                      "--global-batch", "2"])
    assert out["arch"] == "whisper-small-smoke"
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["launches_per_step"]["flash_attention"] == [0, 0]
