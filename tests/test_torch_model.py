"""Model layers and whole steps: the port against the reference on the
same (bridged) weights and the same numpy inputs.

Tolerances: module outputs in bf16 within one bf16 ulp (rtol 8e-3), f32
outputs at 1e-5; whole-step logits within atol 1e-2 (observed: ~1e-7 for
qwen2 smoke, ~3e-3 for gemma2 smoke, whose remaining gap is single-ulp
bf16 rounding flips in the attention block between XLA's fused program
and PyTorch's eager ops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.models import attention as A
from repro.models import modules as M
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models import attention as PA
from repro_torch.models import modules as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

BF16_RTOL = 8e-3
LOGIT_ATOL = 1e-2


@pytest.fixture(scope="module", params=["qwen2-0.5b", "gemma2-2b"])
def model(request):
    cfg = get_smoke_config(request.param)
    # jitted: the same weights as eager init, compiled once
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, port_smoke_config(request.param), params, \
        bridge.from_flat(flat)


def _f(a):
    return np.asarray(a).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close_bf16(ours, theirs):
    np.testing.assert_allclose(ours.float().numpy(), _f(theirs),
                               rtol=BF16_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_modules_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x, torch.bfloat16)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close_bf16(PM.rmsnorm({"scale": _t(scale)}, xt),
                M.rmsnorm({"scale": jnp.asarray(scale)}, xb))
    w = (rng.standard_normal((64, 3, 8)) / 8).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    _close_bf16(PM.linear({"w": _t(w), "b": _t(b)}, xt, torch.bfloat16),
                M.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, xb,
                         jnp.bfloat16))
    mp = {n: (rng.standard_normal(s) / 8).astype(np.float32) for n, s in
          (("wi", (64, 96)), ("wg", (64, 96)), ("wo", (96, 64)))}
    for act in ("silu", "gelu"):
        _close_bf16(
            PM.mlp({n: {"w": _t(v)} for n, v in mp.items()}, xt, act,
                   torch.bfloat16),
            M.mlp({n: {"w": jnp.asarray(v)} for n, v in mp.items()}, xb,
                  act, jnp.bfloat16))
    table = (0.02 * rng.standard_normal((50, 64))).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5)).astype(np.int32)
    _close_bf16(PM.embed({"table": _t(table)}, torch.from_numpy(toks),
                         torch.bfloat16),
                M.embed({"table": jnp.asarray(table)}, jnp.asarray(toks),
                        jnp.bfloat16))
    got = PM.unembed({"table": _t(table)}, xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _f(M.unembed({"table": jnp.asarray(table)}, xb)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        PM.softcap(_t(x * 40), 30.0).numpy(),
        _f(M.softcap(jnp.asarray(x * 40), 30.0)), atol=1e-5, rtol=1e-5)
    pos = np.array([[0, 3, 7, 100, 2047]] * 2, np.int32)
    q = x.reshape(2, 5, 4, 16)
    _close_bf16(PA.apply_rope(_t(q, torch.bfloat16), torch.from_numpy(pos),
                              1e6),
                A.apply_rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos),
                             1e6))


# ---------------------------------------------------------------------------
# the paged attention block
# ---------------------------------------------------------------------------

def _storage(cfg, nb, bs, rng):
    shape = (nb + 1, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
    init = rng.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(init, jnp.bfloat16),
             "v": jnp.asarray(-init, jnp.bfloat16)},
            {"k": _t(init, torch.bfloat16), "v": _t(-init, torch.bfloat16)})


@pytest.mark.parametrize("S", [1, 6])
def test_paged_attention_block_matches_reference(model, S):
    """Outputs and every block the step writes (trash block included)."""
    cfg, pcfg, params, pparams = model
    lp = jax.tree.map(lambda a: a[0, 0], params["layers"])["attn"]
    plp = PT._index(pparams["layers"], 0, 0)["attn"]
    rng = np.random.default_rng(S)
    B, bs, nb = 3, 8, 8
    jc, tc = _storage(cfg, nb, bs, rng)
    tables = np.array([[0, 1, 2], [3, 4, nb], [5, 6, 7]], np.int32)
    starts = np.array([9, 2, 17], np.int32)
    q_lens = np.array([S, max(S - 2, 1), S], np.int32)
    if S == 1:
        q_lens = None
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = starts[:, None] + np.arange(S)[None]
    win = cfg.sliding_window
    ref, rc = jax.jit(
        lambda lp, x, c: A.attention_block(
            lp, cfg, x, positions=jnp.asarray(pos), window=win, cache=c,
            cache_index=jnp.asarray(starts),
            block_tables=jnp.asarray(tables),
            q_lens=None if q_lens is None else jnp.asarray(q_lens)))(
        lp, jnp.asarray(x, jnp.bfloat16), jc)
    ours, oc = PA.attention_block(
        plp, pcfg, _t(x, torch.bfloat16), positions=torch.from_numpy(pos),
        window=win, cache=tc, cache_index=torch.from_numpy(starts),
        block_tables=torch.from_numpy(tables),
        q_lens=None if q_lens is None else torch.from_numpy(q_lens))
    assert oc is tc                                  # updated in place
    np.testing.assert_allclose(ours.float().numpy(), _f(ref), atol=2e-2,
                               rtol=BF16_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(oc[name].float().numpy(), _f(rc[name]),
                                   atol=2e-2, rtol=BF16_RTOL,
                                   err_msg=name)
    if S > 1:
        # row 1's padding token (t = q_len) went to the trash block, not
        # to the live block that backs its position
        t = int(q_lens[1])
        p = int(starts[1]) + t
        live = tables[1, p // bs]
        np.testing.assert_array_equal(oc["k"][live, p % bs].float().numpy(),
                                      _f(jc["k"][live, p % bs]))
        assert not np.array_equal(oc["k"][nb, p % bs].float().numpy(),
                                  _f(jc["k"][nb, p % bs]))


def test_other_attention_branches_wait_for_their_slice(model):
    """Cross-attention (``kv_override``) matches the reference's on a
    3-position source (no RoPE, no mask, the cache left alone); the
    no-cache branch (training's forward) runs; the dense-cache branch runs
    too (one-token decode, this step's k/v written at the row's position
    in place) and refuses a multi-token tile."""
    cfg, pcfg, params, pparams = model
    plp = PT._index(pparams["layers"], 0, 0)["attn"]
    x = torch.ones((1, 2, pcfg.d_model), dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, pcfg.num_kv_heads, pcfg.resolved_head_dim),
                     dtype=torch.bfloat16)
    cache = {"k": kv, "v": kv.clone()}
    idx = torch.full((1,), 2, dtype=torch.int32)
    out, got = PA.attention_block(plp, pcfg, x[:, :1], cache=cache,
                                  cache_index=idx, positions=idx[:, None])
    assert got is cache and out.shape == (1, 1, pcfg.d_model)
    assert cache["k"][0, 2].any() and not cache["k"][0, :2].any()
    with pytest.raises(ValueError, match="one-token"):
        PA.attention_block(plp, pcfg, x, cache=cache, cache_index=idx)
    src = np.random.default_rng(5).standard_normal(
        (1, 3, cfg.d_model)).astype(np.float32)
    xq = np.random.default_rng(6).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0, 0], params["layers"])["attn"]
    want, _ = A.attention_block(lp, cfg, jnp.asarray(xq, jnp.bfloat16),
                                kv_override=jnp.asarray(src),
                                use_rope=False)
    got, none = PA.attention_block(plp, pcfg, _t(xq, torch.bfloat16),
                                   kv_override=_t(src), use_rope=False,
                                   cache=cache, cache_index=idx)
    assert none is None and got.shape == (1, 2, pcfg.d_model)
    _close_bf16(got, want)
    out, cache = PA.attention_block(plp, pcfg, x)
    assert out.shape == x.shape and cache is None


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_match_reference(model):
    cfg, pcfg, params, pparams = model
    rng = np.random.default_rng(11)
    B, C, bs, nb = 3, 8, 8, 12
    pat = len(T.layer_pattern(cfg))
    shape = (cfg.num_layers // pat, pat, nb + 1, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jc = {"layers": {n: jnp.zeros(shape, jnp.bfloat16) for n in "kv"}}
    tc = {"layers": {n: torch.zeros(shape, dtype=torch.bfloat16)
                     for n in "kv"}}
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, nb], [7, 8, 9, 10]], np.int32)
    qlens = np.array([C, 5, 0], np.int32)           # full, partial, padding
    starts = np.zeros(B, np.int32)
    for chunk in range(2):                          # second chunk: start > 0
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        ql = qlens if chunk == 0 else np.array([C, 0, 3], np.int32)
        jl, jc = jax.jit(T.prefill_step, static_argnums=1)(params, cfg, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
            "q_lens": jnp.asarray(ql), "cache": jc,
            "block_tables": jnp.asarray(tables)})
        tl, tc = PT.prefill_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(starts),
            "q_lens": torch.from_numpy(ql), "cache": tc,
            "block_tables": torch.from_numpy(tables)})
        assert tl.dtype == torch.float32 and tl.shape == (B, C,
                                                          cfg.vocab_size)
        for b in range(B):
            np.testing.assert_allclose(tl[b, :ql[b]].numpy(),
                                       _f(jl[b, :ql[b]]), atol=LOGIT_ATOL,
                                       rtol=0)
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
        np.testing.assert_allclose(tl.numpy(), _f(jl), atol=LOGIT_ATOL,
                                   rtol=0)
        starts = starts + 1
