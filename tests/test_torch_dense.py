"""Dense-mode serving and the int8 KV cache: the port against the
reference on the same numpy inputs and the same (bridged) weights.

- the int8 attention's plain version (``ref.attention_int8kv_ref``, what
  ``flash_attention_int8kv`` runs on a CPU tensor) against the
  reference's Pallas ``flash_attention_int8kv`` in interpret mode, and
  against the reference's jnp ``attend`` on dequantized K/V with per-row
  query positions, lengths and GQA;
- the quantizer, the dense-cache branch of ``attention_block`` (int8 and
  bf16) and 8 ``decode_step``s over an int8 cache against the jitted
  reference;
- ``PagedKVCache``'s dense layout (``write_prefill``, prefix save/load,
  ``kv_bytes``), and ``Scheduler`` + ``ServingEngine(paged=False)`` with
  greedy tokens identical to the reference's dense engine.

Tolerances: f32 kernel inputs at atol 2e-5 (``tests/test_kernels.py``'s
own for the int8 kernel: f32 sums in another order); the quantizer and
the int8 attention over equal bf16 inputs bit-identical (the port
dequantizes as the jitted reference reads: K rounded to bf16, V not);
the whole attention block within one bf16 ulp or one int8 code (its
projections are GEMMs summed in another order); decode logits within
atol 1e-2 (``test_torch_model.py``'s); greedy tokens identical, qwen2
smoke at tie-eps 1e-2 and gemma2 smoke at raw argmax, as
``test_torch_serving.py`` holds the paged engine.  One case is a known
gap (ROADMAP Queue 3): gemma2 smoke with the int8 cache at raw argmax,
a strict expected failure beside the tests that bound it.  On the card:
the kernel's bf16 output within one bf16 ulp of its plain version,
element by element (|err| <= 2^-7 x max(|plain|, 2^-4)), f32 at atol
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.kernels.flash_attention import \
    flash_attention_int8kv as pallas_int8kv
from repro.models import attention as A
from repro.models import transformer as T
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import Scheduler as RefScheduler
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import PagedKVCache as RefKV
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                 ServingEngine)
from repro_torch.serving.kvcache import PagedKVCache

torch.set_num_threads(2)

F32_ATOL = 2e-5
BF16_RTOL = 8e-3
LOGIT_ATOL = 1e-2
TIE_EPS = {"qwen2-0.5b": 1e-2, "gemma2-2b": 0.0}


def _quant_np(x):
    """The TPU kernel test's quantizer (f32 scales), in numpy."""
    s = np.abs(x).max(-1) / np.float32(127.0) + np.float32(1e-8)
    return np.round(x / s[..., None]).astype(np.int8), s.astype(np.float32)


@pytest.fixture(scope="module", params=["qwen2-0.5b", "gemma2-2b"])
def model(request):
    cfg = get_smoke_config(request.param)
    # jitted: the same weights as eager init, compiled once
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return request.param, cfg, port_smoke_config(request.param), params, \
        bridge.from_flat(flat)


# ---------------------------------------------------------------------------
# the int8 attention: plain version vs the TPU kernel and the jnp attend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,Sq,Skv,D,window", [
    (2, 1, 256, 64, None),              # tests/test_kernels.py's shapes
    (2, 128, 128, 64, None),
    (1, 1, 300, 128, 64),
])
def test_int8kv_plain_matches_pallas_kernel(BH, Sq, Skv, D, window):
    """Heads folded into the batch (H = KV = 1), q_start = 0, kv_len =
    Skv: the TPU kernel's own function, with its test's f32 inputs."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((BH, Sq, D)).astype(np.float32)
    k8, ks = _quant_np(rng.standard_normal((BH, Skv, D)).astype(np.float32))
    v8, vs = _quant_np(rng.standard_normal((BH, Skv, D)).astype(np.float32))
    want = pallas_int8kv(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks),
                         jnp.asarray(v8), jnp.asarray(vs), causal=True,
                         window=window, interpret=True)
    t = torch.from_numpy
    got = fa.flash_attention_int8kv(
        t(q)[:, :, None], t(k8)[:, :, None], t(ks)[:, :, None],
        t(v8)[:, :, None], t(vs)[:, :, None],
        torch.zeros(BH, dtype=torch.int32),
        torch.full((BH,), Skv, dtype=torch.int32), causal=True,
        window=window)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0)])
def test_int8kv_plain_matches_attend_per_row(window, softcap):
    """GQA (H 4 over KV 2), Sq = 3 queries per row at q_start[b] + i,
    keys masked past kv_len[b], against the reference's jnp ``attend``
    over each row's dequantized keys; a row with kv_len 0 is zeros."""
    rng = np.random.default_rng(7)
    B, Sq, Skv, KV, G, D = 4, 3, 20, 2, 2, 16
    q = rng.standard_normal((B, Sq, KV * G, D)).astype(np.float32)
    k8, ks = _quant_np(rng.standard_normal((B, Skv, KV, D)).astype(np.float32))
    v8, vs = _quant_np(rng.standard_normal((B, Skv, KV, D)).astype(np.float32))
    q_start = np.array([0, 4, 17, 9], np.int32)
    kv_len = np.array([3, 20, 20, 0], np.int32)
    t = torch.from_numpy
    got = ops.int8kv_attention(t(q), t(k8), t(ks), t(v8), t(vs), t(q_start),
                               t(kv_len), window=window, softcap=softcap,
                               scale=0.3)
    kd = k8.astype(np.float32) * ks[..., None]
    vd = v8.astype(np.float32) * vs[..., None]
    for b in range(3):
        n = int(kv_len[b])
        want = A.attend(jnp.asarray(q[b:b + 1]).reshape(1, Sq, KV, G, D),
                        jnp.asarray(kd[b:b + 1, :n]),
                        jnp.asarray(vd[b:b + 1, :n]), scale=0.3,
                        causal=True, window=window, softcap_val=softcap,
                        q_positions=jnp.asarray(q_start[b] + np.arange(Sq)),
                        k_positions=jnp.arange(n))
        np.testing.assert_allclose(
            got[b].numpy(), np.asarray(want).reshape(Sq, KV * G, D),
            atol=F32_ATOL, rtol=0, err_msg=f"row {b}")
    assert (got[3] == 0).all()


def test_int8kv_dequantizes_k_in_q_dtype_and_v_in_f32():
    """bf16 q: K's product rounds to bf16 before the score dot and V's
    stays f32 (what the jitted reference reads); f32 q: neither rounds."""
    rng = np.random.default_rng(3)
    k8 = torch.from_numpy(rng.integers(-127, 128, (1, 6, 1, 8), np.int8))
    sc = torch.from_numpy(rng.uniform(0.003, 0.02, (1, 6, 1))
                          .astype(np.float32)).bfloat16()
    for dtype, k_rounds in ((torch.bfloat16, True), (torch.float32, False)):
        k, v = tref.dequantize_kv(k8, sc, k8, sc, dtype)
        exact = k8.float() * sc.float()[..., None]
        assert torch.equal(v, exact)
        assert torch.equal(k, exact.bfloat16().float() if k_rounds
                           else exact)
        assert not torch.equal(exact.bfloat16().float(), exact)


# ---------------------------------------------------------------------------
# the dense-cache attention block and decode steps
# ---------------------------------------------------------------------------

def _layer(params, pparams):
    return (jax.tree.map(lambda a: a[0, 0], params["layers"])["attn"],
            PT._index(pparams["layers"], 0, 0)["attn"])


def _dense_caches(cfg, rng, B, Smax):
    """One layer's dense cache with random prior content, as a JAX and a
    torch tree (the port's is updated in place)."""
    KV, D = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.kv_cache_dtype == "int8":
        k8 = rng.integers(-127, 128, (B, Smax, KV, D)).astype(np.int8)
        sc = rng.uniform(0.002, 0.03, (B, Smax, KV)).astype(np.float32)
        leaves = {"k": k8, "v": -k8, "k_scale": sc, "v_scale": 0.5 * sc}
        return ({n: jnp.asarray(a, jnp.bfloat16 if a.dtype == np.float32
                                else a.dtype) for n, a in leaves.items()},
                {n: (torch.from_numpy(a).bfloat16() if a.dtype == np.float32
                     else torch.from_numpy(a.copy()))
                 for n, a in leaves.items()})
    init = rng.standard_normal((B, Smax, KV, D)).astype(np.float32)
    return ({"k": jnp.asarray(init, jnp.bfloat16),
             "v": jnp.asarray(-init, jnp.bfloat16)},
            {"k": torch.from_numpy(init).bfloat16(),
             "v": torch.from_numpy(-init).bfloat16()})


def _ref_block(cfg, lp, x, cache, idx, window):
    return jax.jit(lambda lp, x, c: A.attention_block(
        lp, cfg, x, positions=jnp.asarray(idx[:, None]), window=window,
        cache=c, cache_index=jnp.asarray(idx)))(
        lp, jnp.asarray(x, jnp.bfloat16), cache)


def test_quantizer_matches_reference_attention_block(model):
    """The int8 branch's codes and scales at this step's positions equal
    ``quantize_kv`` of the bf16 k and v the bf16 branch writes there."""
    _, cfg, _, params, pparams = model
    lp, _ = _layer(params, pparams)
    rng = np.random.default_rng(5)
    B, Smax = 4, 16
    idx = np.array([0, 3, 15, 7], np.int32)
    x = 3.0 * rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    rows = np.arange(B)
    c8 = cfg.with_(kv_cache_dtype="int8")
    _, q_cache = _ref_block(c8, lp, x, _dense_caches(c8, rng, B, Smax)[0],
                            idx, None)
    _, b_cache = _ref_block(cfg, lp, x, _dense_caches(cfg, rng, B, Smax)[0],
                            idx, None)
    for name in ("k", "v"):
        bf = torch.from_numpy(np.asarray(b_cache[name][rows, idx],
                                         np.float32)).bfloat16()
        codes, scales = PA.quantize_kv(bf)
        assert codes.dtype == torch.int8 and scales.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(q_cache[name][rows, idx]))
        np.testing.assert_array_equal(
            scales.float().numpy(),
            np.asarray(q_cache[f"{name}_scale"][rows, idx], np.float32))


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
def test_dense_attention_block_matches_reference(model, kv_dtype):
    """One decode step over a dense cache (rows at the first, a middle and
    the last position; gemma2's layer 0 is windowed) against the jitted
    reference: the output within one bf16 ulp, every cache leaf within
    one bf16 ulp or one int8 code.  (Seed 9 is one where a v projection
    differs from XLA's GEMM in one bf16 rounding, so the written code and
    the output differ there; the quantizer and the attention over equal
    inputs are bit-identical, as the tests beside this one show.)"""
    _, cfg, pcfg, params, pparams = model
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    lp, plp = _layer(params, pparams)
    rng = np.random.default_rng(9)
    B, Smax = 3, 24
    jc, tc = _dense_caches(cfg, rng, B, Smax)
    idx = np.array([0, 9, 23], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    win = cfg.sliding_window
    ref, rc = _ref_block(cfg, lp, x, jc, idx, win)
    ours, oc = PA.attention_block(
        plp, pcfg, torch.from_numpy(x).bfloat16(),
        positions=torch.from_numpy(idx[:, None]), window=win, cache=tc,
        cache_index=torch.from_numpy(idx))
    assert oc is tc                                  # updated in place
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2,
                               rtol=BF16_RTOL)
    assert sorted(oc) == sorted(rc)
    for name in oc:
        got = oc[name].float().numpy()
        want = np.asarray(rc[name]).astype(np.float32)
        if oc[name].dtype == torch.int8:
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=0, rtol=BF16_RTOL,
                                       err_msg=name)


def test_int8kv_plain_reads_what_the_jitted_reference_reads():
    """The reference's int8 branch (dequantize in bf16, then ``attend``
    with the query at each row's position), jitted, against the port's
    int8 attention on the same cache and bf16 query: bit-identical."""
    rng = np.random.default_rng(0)
    B, Smax, KV, G, D = 3, 40, 2, 2, 32
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, Smax, KV, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, Smax, KV, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, Smax, KV)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, Smax, KV)).astype(np.float32)
    idx = np.array([5, 17, 39], np.int32)
    bf = jnp.bfloat16

    @jax.jit
    def ref(q, k8, ks, v8, vs, idx):
        kd = k8.astype(bf) * ks.astype(bf)[..., None]
        vd = v8.astype(bf) * vs.astype(bf)[..., None]
        return A.attend(q.reshape(B, 1, KV, G, D), kd, vd,
                        scale=1 / np.sqrt(D), causal=True, window=16,
                        softcap_val=50.0, q_positions=idx[:, None],
                        k_positions=jnp.arange(Smax))

    want = ref(jnp.asarray(q, bf), jnp.asarray(k8), jnp.asarray(ks, bf),
               jnp.asarray(v8), jnp.asarray(vs, bf), jnp.asarray(idx))
    t = torch.from_numpy
    got = ops.int8kv_attention(
        t(q).bfloat16(), t(k8), t(ks).bfloat16(), t(v8), t(vs).bfloat16(),
        t(idx), t(idx) + 1, window=16, softcap=50.0, scale=1 / np.sqrt(D))
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(want, np.float32).reshape(B, 1, KV * G, D))


def test_dense_writes_past_the_cache_are_dropped():
    """A row at a position past the stripe (dense prefill's padding
    tokens) writes nothing, as the reference's scatter drops it."""
    cfg = port_smoke_config("qwen2-0.5b").with_(kv_cache_dtype="int8")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    plp = PT._index(params["layers"], 0, 0)["attn"]
    cache = PT._index(PT.init_cache(cfg, 2, 8)["layers"], 0, 0)
    before = {n: t.clone() for n, t in cache.items()}
    x = torch.randn((2, 1, cfg.d_model)).bfloat16()
    idx = torch.tensor([3, 8])
    out, _ = PA.attention_block(plp, cfg, x, positions=idx[:, None],
                                cache=cache, cache_index=idx)
    assert torch.isfinite(out.float()).all()
    for n, t in cache.items():
        assert torch.equal(t[1], before[n][1]), n      # row 1: nothing
        assert not torch.equal(t[0, 3], before[n][0, 3]), n


def test_int8_decode_steps_match_reference(model):
    """Eight decode steps over an int8 dense cache from position 0
    (``tests/test_transformer.py``'s int8 decode case): logits within
    1e-2 of the jitted reference's at every step, and the cache's codes
    within one code at the end (k projections summed in another order
    flip a rounding in under 1% of them)."""
    _, cfg, pcfg, params, pparams = model
    cfg8 = cfg.with_(kv_cache_dtype="int8")
    pcfg8 = pcfg.with_(kv_cache_dtype="int8")
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jc = T.init_cache(cfg8, B, S + 4)
    tc = PT.init_cache(pcfg8, B, S + 4)
    assert tc["layers"]["k"].dtype == torch.int8
    assert {n: tuple(t.shape) for n, t in tc["layers"].items()} == \
        {n: tuple(a.shape) for n, a in jc["layers"].items()}
    step = jax.jit(T.decode_step, static_argnums=1)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jc = step(params, cfg8, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "positions": jnp.asarray(pos),
                                     "cache": jc})
        tl, tc = PT.decode_step(pparams, pcfg8, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "positions": torch.from_numpy(pos), "cache": tc})
        assert tl.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=str(t))
    diff = (tc["layers"]["k"].int() - torch.from_numpy(
        np.array(jc["layers"]["k"])).int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 0.01


# ---------------------------------------------------------------------------
# the dense KV layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
def test_dense_kv_cache_layout(kv_dtype):
    """``write_prefill`` copies a batch-1 cache into its slot; prefix
    blocks saved from the slot load back bit-identical (int8 codes and
    bf16 scales alike); ``kv_bytes`` equals the reference's; the dense
    layout refuses an undersized pool, and paged mode the int8 cache."""
    cfg = port_smoke_config("qwen2-0.5b").with_(kv_cache_dtype=kv_dtype)
    ref_cfg = get_smoke_config("qwen2-0.5b").with_(kv_cache_dtype=kv_dtype)
    bs, S = 8, 32
    kv = PagedKVCache(cfg, 3, S, block_size=bs, prefix_blocks=4,
                      device="cpu")
    assert not kv.paged and kv.supports_prefix_cache
    assert kv.kv_bytes() == RefKV(ref_cfg, 3, S, block_size=bs).kv_bytes()
    g = torch.Generator().manual_seed(0)

    def rand_like(t):
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=g,
                                 dtype=torch.int8)
        return torch.randn(t.shape, generator=g).to(t.dtype)

    one = {"layers": {n: rand_like(t) for n, t in
                      PT.init_cache(cfg, 1, S)["layers"].items()}}
    slot = kv.alloc_slot(20)
    kv.write_prefill(slot, one)
    for n, t in kv.cache["layers"].items():
        assert torch.equal(t[:, :, slot], one["layers"][n][:, :, 0]), n
        assert not t[:, :, 1 - slot].any(), n          # other slots: zeros
    bids = [kv.save_prefix_block(slot, b * bs) for b in range(2)]
    fresh = PT.init_cache(cfg, 1, S)
    assert kv.load_prefix_blocks(fresh, bids) is fresh
    for n, t in fresh["layers"].items():
        assert torch.equal(t[:, :, :, :2 * bs],
                           one["layers"][n][:, :, :, :2 * bs]), n
        assert not t[:, :, :, 2 * bs:].any(), n
    kv.free_slot(slot)
    assert kv.occupancy()["kv_bytes_resident"] == kv.kv_bytes()
    with pytest.raises(ValueError, match="worst case"):
        PagedKVCache(cfg, 3, S, block_size=bs, num_blocks=5, device="cpu")
    if kv_dtype == "int8":
        with pytest.raises(ValueError, match="int8"):
            PagedKVCache(cfg, 3, S, block_size=bs, paged=True, device="cpu")


# ---------------------------------------------------------------------------
# dense-mode serving end to end
# ---------------------------------------------------------------------------

def _serve(engine_cls, sched_cls, req_cls, sp_cls, cfg, params, prompts,
           max_new, engine_kw, sched_kw):
    eng = engine_cls(cfg, params, **engine_kw)
    sched = sched_cls(eng, **sched_kw)
    rids = [sched.submit(req_cls(p, sp_cls(max_new_tokens=m, greedy=True)))
            for p, m in zip(prompts, max_new)]
    sched.run()
    return [sched.output(r).tolist() for r in rids], sched


# The one case that cannot be held token-identical at its family's tie-eps
# (ROADMAP Queue 3): gemma2 smoke with the int8 cache at raw argmax meets a
# near-tie (reference top-2 margin 7.3e-4 at request 1's third token) where
# one int8 code written from a k/v projection summed in another order moves
# the port's logits by 8.8e-4.  It stays at raw argmax as a strict expected
# failure; ``test_dense_raw_argmax_divergences_are_near_ties`` holds that
# run to "equal, or a near-tie inside the logit gap", and
# ``test_dense_gemma2_int8_serving_at_qwen2_tie_eps`` checks the rest of the
# serving run (tokens under one tie rule, counters, leaks).
KNOWN_GAPS = {("gemma2-2b", "int8"): "ROADMAP Queue 3: a near-tie (margin "
              "7.3e-4) inside the logit gap of one int8 code (8.8e-4)"}


def _serving_case(cfg):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n,
                                                    dtype=np.int32)])
               for n in (3, 9, 1, 26, 6)]
    return prompts, (6, 4, 7, 3, 5)


def _dense_engine_kw(tie_eps):
    return dict(max_seq_len=46, max_slots=3, kv_block_size=8,
                prefill_chunk=8, prefix_cache_blocks=8,
                greedy_tie_eps=tie_eps)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_dense_scheduler_greedy_tokens_match_reference(model, kv_dtype,
                                                       request):
    """A shared-prefix burst through the prefix cache with budgeted
    (interleaved) prefill, one prompt's last chunk running past
    max_seq_len: identical greedy tokens, control-flow counters and
    staging bytes, and no leaked slot, block or prefix pin."""
    arch = model[0]
    if (arch, kv_dtype) in KNOWN_GAPS:
        request.applymarker(pytest.mark.xfail(
            strict=True, reason=KNOWN_GAPS[arch, kv_dtype]))
    _check_dense_serving(model, kv_dtype, TIE_EPS[arch])


def test_dense_gemma2_int8_serving_at_qwen2_tie_eps():
    """The known gap's serving run with both engines on qwen2's tie rule
    (tie-eps 1e-2, the lowest id within eps of the max): identical
    tokens, counters and staging bytes, and nothing leaked."""
    cfg = get_smoke_config("gemma2-2b")
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    pparams = bridge.from_flat(
        {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()})
    _check_dense_serving(("gemma2-2b", cfg, port_smoke_config("gemma2-2b"),
                          params, pparams), "int8", TIE_EPS["qwen2-0.5b"])


def _check_dense_serving(model, kv_dtype, tie_eps):
    arch, cfg, pcfg, params, pparams = model
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    prompts, max_new = _serving_case(cfg)
    engine_kw = _dense_engine_kw(tie_eps)
    sched_kw = dict(prefill_token_budget=8)
    ref, ref_sched = _serve(RefEngine, RefScheduler, RefRequest,
                            RefSamplingParams, cfg, params, prompts, max_new,
                            engine_kw, sched_kw)
    ours, sched = _serve(ServingEngine, Scheduler, Request, SamplingParams,
                         pcfg, pparams, prompts, max_new,
                         dict(engine_kw, device="cpu"), sched_kw)
    eng, ref_eng = sched.engine, ref_sched.engine
    assert not eng.paged and not ref_eng.paged
    assert ours == ref
    assert [len(o) for o in ours] == list(max_new)
    for counter in ("decode_steps", "prefill_tokens",
                    "prefill_tokens_executed", "prefill_tokens_padding",
                    "cached_prefix_tokens", "transient_prefill_bytes"):
        assert getattr(eng, counter) == getattr(ref_eng, counter), counter
    assert sched.admission_stalls == ref_sched.admission_stalls
    assert sched.metrics.prefix_hits > 0
    assert sched.metrics.budget_rounds > 0
    assert eng.kv.kv_bytes() == ref_eng.kv.kv_bytes()
    kv = eng.kv
    assert not (sched.queue or sched.active or sched.prefilling)
    assert kv.free_slot_count == kv.max_slots and kv.pool.in_use == 0
    assert not eng._inflight
    eng.prefix_cache.evict(kv.prefix_pool.num_blocks)
    assert kv.prefix_pool.in_use == 0


def test_dense_raw_argmax_divergences_are_near_ties():
    """gemma2 smoke, int8 cache, raw argmax: each prompt of the serving
    case prefilled alone and decoded 8 steps on the reference's tokens.
    The logits stay within 1e-2 of the reference's at every step, and
    wherever the argmax differs the reference's top-2 margin is smaller
    than the logit gap there (a near-tie, not a wrong token)."""
    cfg = get_smoke_config("gemma2-2b")
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    pparams = bridge.from_flat(
        {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()})
    cfg = cfg.with_(kv_cache_dtype="int8")
    pcfg = port_smoke_config("gemma2-2b").with_(kv_cache_dtype="int8")
    kw = dict(_dense_engine_kw(0.0), prefix_cache_blocks=0)
    ref_eng = RefEngine(cfg, params, **kw)
    eng = ServingEngine(pcfg, pparams, device="cpu", **kw)
    flips = 0
    for prompt in _serving_case(cfg)[0]:
        rs, rl = ref_eng.prefill_into_slot(prompt)
        ps, pl = eng.prefill_into_slot(prompt)
        pos = len(prompt)
        for _ in range(8):
            rl, pl = np.asarray(rl, np.float32), np.asarray(pl, np.float32)
            gap = float(np.abs(rl - pl).max())
            assert gap <= LOGIT_ATOL
            if rl.argmax() != pl.argmax():
                top2 = np.sort(rl)[-2:]
                assert top2[1] - top2[0] < gap
                flips += 1
            tok = int(rl.argmax())
            toks = np.zeros(3, np.int32)
            poss = np.zeros(3, np.int32)
            toks[rs], poss[rs] = tok, pos
            rl = np.asarray(ref_eng.decode_once(toks, poss))[rs]
            toks[:], poss[:] = 0, 0
            toks[ps], poss[ps] = tok, pos
            pl = eng.decode_once(toks, poss)[ps].float().numpy()
            pos += 1
        ref_eng.free_slot(rs)
        eng.free_slot(ps)
    assert flips <= 2


# ---------------------------------------------------------------------------
# on the card: the CUDA int8 kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,H,KV,D,Skv,window,softcap,dtype,q_start,kv_len", [
    # qwen2 decode: positions 0, Skv - 1 and a middle one; a row with no key
    (1, 14, 2, 64, 300, None, None, "bf16", [0, 299, 150, 7], [1, 300, 151,
                                                                0]),
    # the dense prompt replay: B = 1 against a 1,024-position stripe
    (1, 14, 2, 64, 1024, None, None, "bf16", [77], [78]),
    # gemma2 decode, window and softcap
    (1, 8, 4, 288, 200, 64, 50.0, "bf16", [0, 199, 100], [1, 200, 101]),
    # the TPU kernel's function: q_start 0, kv_len Skv (its test's shapes)
    (128, 1, 1, 64, 128, None, None, "f32", [0, 0], [128, 128]),
    (1, 1, 1, 128, 300, 64, None, "f32", [299], [300]),
    # several queries per row
    (5, 4, 2, 32, 70, 9, 30.0, "bf16", [10, 65], [15, 70]),
    # zamba2's shared block, MHA (G = 1): decode over 1,024-position
    # stripes, and the B = 1 prompt replay
    (1, 32, 32, 64, 1024, None, None, "bf16",
     [0, 146, 292, 438, 584, 730, 876, 1023],
     [1, 147, 293, 439, 585, 731, 877, 1024]),
    (1, 32, 32, 64, 1024, None, None, "bf16", [77], [78]),
])
def test_cuda_int8kv_matches_plain(cuda, Sq, H, KV, D, Skv, window, softcap,
                                   dtype, q_start, kv_len):
    """The kernel against its plain version with per-row q_start / kv_len,
    the launch count, and zeros for a row with no key; f32 at atol 1e-5
    (sums in another order), bf16 element by element within one ulp:
    |err| <= 2^-7 x max(|plain|, 2^-4)."""
    B = len(q_start)
    rng = np.random.default_rng(D + Skv)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.tensor(rng.standard_normal((B, Sq, H, D)), dtype=dt,
                     device=cuda)
    k8, ks = PA.quantize_kv(torch.tensor(
        rng.standard_normal((B, Skv, KV, D)), device=cuda))
    v8, vs = PA.quantize_kv(torch.tensor(
        rng.standard_normal((B, Skv, KV, D)), device=cuda))
    args = (q, k8, ks.to(dt), v8, vs.to(dt),
            torch.tensor(q_start, dtype=torch.int32, device=cuda),
            torch.tensor(kv_len, dtype=torch.int32, device=cuda))
    kw = dict(window=window, softcap=softcap)
    launches = fa.flash_attention_int8kv.launches
    got = fa.flash_attention_int8kv(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8kv.launches == launches + 1
    want = tref.attention_int8kv_ref(*args, **kw)
    err = (got.float() - want.float()).abs()
    if dtype == "f32":
        assert err.max().item() <= 1e-5
    else:
        assert (err <= 2.0 ** -7 * want.float().abs().clamp(
            min=2.0 ** -4)).all()
    for b, n in enumerate(kv_len):
        if n == 0:
            assert (got[b] == 0).all()


@pytest.mark.gpu
def test_cuda_int8kv_raises_on_wrong_inputs(cuda):
    q = torch.zeros((1, 1, 2, 8), dtype=torch.bfloat16, device=cuda)
    k8 = torch.zeros((1, 4, 1, 8), dtype=torch.int8, device=cuda)
    sc = torch.ones((1, 4, 1), dtype=torch.bfloat16, device=cuda)
    n = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_int8kv(q, k8.float(), sc, k8, sc, n, n)
    with pytest.raises(TypeError):
        fa.flash_attention_int8kv(q, k8, sc, k8, sc, n.long(), n)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_int8kv(q, k8, sc.float(), k8, sc.float(), n, n)
    with pytest.raises(ValueError, match="multiple of 4"):
        k6 = k8[..., :6].contiguous()
        fa.flash_attention_int8kv(q[..., :6].contiguous(), k6, sc, k6, sc,
                                  n, n)
    with pytest.raises(ValueError):
        fa.flash_attention_int8kv(q, k8, sc, k8, sc, n.cpu(), n)
