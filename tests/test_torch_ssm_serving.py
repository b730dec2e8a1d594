"""Dense-mode serving of the ssm (mamba2) and hybrid (zamba2) families,
the port against the reference on the same bridged weights: the decode
cache (mamba state with a batch axis and no sequence axis; zamba2's
shared block with one K/V stripe a group, bf16 or int8), ``decode_step``
against the port's own ``forward`` and against the reference's,
``Scheduler`` greedy tokens against the reference engine's, the
refusals the reference makes (paged mode, the prefix store, paged
prefill), slot reuse, and the launcher.

Tolerances, and why:
- decode against forward, teacher-forced, f32: atol 2e-3, the
  reference's own ``tests/test_transformer.py`` bound (the chunked scan
  and the one-token recurrence sum in another order; observed ~1e-6);
- 8 ``decode_step``s against the jitted reference's, bf16: logits atol
  1e-2 at every step (as the dense int8 case; observed below 5e-3);
- greedy tokens: identical with every control-flow counter equal, at
  raw argmax for the three cases and at tie-eps 1e-2 (the engine's
  default) for mamba2.  zamba2 at tie-eps 1e-2 is a logged gap
  (``KNOWN_GAPS``, ROADMAP Queue 3): the port's f32 recurrent state
  differs from the reference's in the last bit (XLA's exp, and its
  fused multiply-add in the state update), which flips one bf16
  rounding ten tokens into a prompt and leaves the logits ~5e-3 apart
  from there; a reference top-2 margin of 1.01e-2 (bf16) or 6.6e-3
  (int8) then sits within that gap of the tie rule's 1e-2 boundary.
  ``test_tie_eps_divergences_are_boundary_near_ties`` holds those runs
  to "the same pick, or a token within the logit gap of the boundary".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

DECODE_FWD_ATOL = 2e-3
LOGIT_ATOL = 1e-2
TIE_EPS = 1e-2
# (arch, kv_cache_dtype): mamba2 has no attention cache
CASES = [("mamba2-1.3b", "bfloat16"), ("zamba2-1.2b", "bfloat16"),
         ("zamba2-1.2b", "int8")]
IDS = ["mamba2", "zamba2-bf16", "zamba2-int8"]


def _bridged(arch):
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs import get_smoke_config
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config as port_smoke_config
    cfg = get_smoke_config(arch)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, port_smoke_config(arch), params, bridge.from_flat(flat)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = _bridged(arch)
    return _MODELS[arch]


def _leaf_shapes(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _leaf_shapes(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_decode_matches_forward(arch):
    """Teacher-forced ``decode_step`` from an empty cache reproduces the
    port's ``forward`` logits (f32), as the reference's own test holds
    its decode to its forward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as PT
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 20
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32))
    with torch.no_grad():
        want, _ = PT.forward(params, cfg, {"tokens": toks})
    cache = PT.init_cache(cfg, B, S + 4)
    got = []
    for t in range(S):
        lg, out = PT.decode_step(params, cfg, {
            "tokens": toks[:, t:t + 1],
            "positions": torch.full((B,), t, dtype=torch.int32),
            "cache": cache})
        assert out is cache
        got.append(lg)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want.numpy(),
                               atol=DECODE_FWD_ATOL, rtol=0)


@pytest.mark.parametrize("arch,kv_dtype", CASES, ids=IDS)
def test_decode_steps_match_reference(arch, kv_dtype):
    """Eight decode steps from position 0 in bf16: the cache tree has the
    reference's leaves, shapes and dtypes, the logits stay within 1e-2
    of the jitted reference's at every step, and every leaf is updated
    in place (the engine's programs read the leaves at their
    addresses)."""
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    from repro_torch.serving.kvcache import _leaves
    cfg, pcfg, params, pparams = _model(arch)
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jc = T.init_cache(cfg, B, S + 4)
    tc = PT.init_cache(pcfg, B, S + 4)
    ref_shapes = {k: (s, d.replace("bfloat16", "torch.bfloat16")
                      .replace("float32", "torch.float32")
                      .replace("int8", "torch.int8"))
                  for k, (s, d) in _leaf_shapes(jax.tree.map(
                      lambda a: np.empty(a.shape, np.dtype(a.dtype)),
                      jc)).items()}
    assert _leaf_shapes(tc) == ref_shapes
    ptrs = [t.data_ptr() for _, t in _leaves(tc)]
    step = jax.jit(T.decode_step, static_argnums=1)
    worst = 0.0
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jl, jc = step(params, cfg, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                    "positions": jnp.asarray(pos),
                                    "cache": jc})
        tl, tc = PT.decode_step(pparams, pcfg, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "positions": torch.from_numpy(pos), "cache": tc})
        assert tl.shape == (B, 1, cfg.vocab_size)
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert worst <= LOGIT_ATOL, worst
    assert [t.data_ptr() for _, t in _leaves(tc)] == ptrs
    # the recurrent state moved
    assert tc["layers"]["ssm"].abs().sum() > 0


def _prompts(cfg):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n,
                                                    dtype=np.int32)])
               for n in (3, 9, 1, 26, 6)]
    return prompts, (6, 4, 7, 3, 5)


def _serve(engine_cls, sched_cls, req_cls, sp_cls, cfg, params, prompts,
           max_new, engine_kw, sched_kw):
    eng = engine_cls(cfg, params, **engine_kw)
    sched = sched_cls(eng, **sched_kw)
    rids = [sched.submit(req_cls(p, sp_cls(max_new_tokens=m, greedy=True)))
            for p, m in zip(prompts, max_new)]
    sched.run()
    return [sched.output(r).tolist() for r in rids], sched


# The cases that cannot be held token-identical at tie-eps 1e-2 (module
# docstring; ROADMAP Queue 3).  They stay as strict expected failures;
# the raw-argmax runs below are token-identical, and
# ``test_tie_eps_divergences_are_boundary_near_ties`` explains each
# divergence.
KNOWN_GAPS = {
    ("zamba2-1.2b", kv): "ROADMAP Queue 3: a reference margin within the "
    "logit gap (~5e-3, f32 state noise) of the 1e-2 tie boundary"
    for kv in ("bfloat16", "int8")}


@pytest.mark.parametrize("arch,kv_dtype", CASES, ids=IDS)
def test_scheduler_greedy_tokens_match_reference(arch, kv_dtype, request):
    """A shared-prefix burst with budgeted (interleaved) prefill, prefix
    blocks asked for, one prompt's last chunk running past max_seq_len,
    at tie-eps 1e-2: the prefix cache stays off in both engines, the
    greedy tokens, the counters and the staging bytes are identical, and
    nothing leaks."""
    if (arch, kv_dtype) in KNOWN_GAPS:
        request.applymarker(pytest.mark.xfail(
            strict=True, reason=KNOWN_GAPS[arch, kv_dtype]))
    _check_serving(arch, kv_dtype, TIE_EPS)


@pytest.mark.parametrize("arch,kv_dtype", CASES, ids=IDS)
def test_scheduler_greedy_tokens_match_reference_at_raw_argmax(arch,
                                                               kv_dtype):
    """The same run with both engines at raw argmax (tie-eps 0)."""
    _check_serving(arch, kv_dtype, 0.0)


def _check_serving(arch, kv_dtype, tie_eps):
    from repro.serving import Request as RefRequest
    from repro.serving import SamplingParams as RefSamplingParams
    from repro.serving import Scheduler as RefScheduler
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg, pcfg, params, pparams = _model(arch)
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    prompts, max_new = _prompts(cfg)
    engine_kw = dict(max_seq_len=46, max_slots=3, kv_block_size=8,
                     prefill_chunk=8, prefix_cache_blocks=8,
                     greedy_tie_eps=tie_eps)
    sched_kw = dict(prefill_token_budget=8)
    ref, ref_sched = _serve(RefEngine, RefScheduler, RefRequest,
                            RefSamplingParams, cfg, params, prompts, max_new,
                            engine_kw, sched_kw)
    ours, sched = _serve(ServingEngine, Scheduler, Request, SamplingParams,
                         pcfg, pparams, prompts, max_new,
                         dict(engine_kw, device="cpu"), sched_kw)
    eng, ref_eng = sched.engine, ref_sched.engine
    assert eng.prefix_cache is None and ref_eng.prefix_cache is None
    assert ours == ref
    assert [len(o) for o in ours] == list(max_new)
    for counter in ("decode_steps", "prefill_tokens",
                    "prefill_tokens_executed", "prefill_tokens_padding",
                    "cached_prefix_tokens", "transient_prefill_bytes"):
        assert getattr(eng, counter) == getattr(ref_eng, counter), counter
    assert sched.metrics.budget_rounds > 0
    assert eng.kv.kv_bytes() == ref_eng.kv.kv_bytes()
    kv = eng.kv
    assert not (sched.queue or sched.active or sched.prefilling)
    assert kv.free_slot_count == kv.max_slots and kv.pool.in_use == 0
    assert not eng._inflight


def _tie_pick(logits, eps):
    """The engines' greedy rule: the lowest id within eps of the max."""
    return int(np.argmax(logits >= logits.max() - eps))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_tie_eps_divergences_are_boundary_near_ties(kv_dtype):
    """zamba2 smoke at tie-eps 1e-2: each prompt of the serving case
    prefilled alone and decoded 8 steps on the reference's tokens.  The
    logits stay within 1e-2 of the reference's at every step; the raw
    argmax never differs; and wherever the tie rule's pick differs, some
    token's distance below the reference's max lies within the logit gap
    of the rule's 1e-2 boundary (a near-tie at the boundary, not a wrong
    token)."""
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.serving import ServingEngine
    cfg, pcfg, params, pparams = _model("zamba2-1.2b")
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = pcfg.with_(kv_cache_dtype=kv_dtype)
    kw = dict(max_seq_len=46, max_slots=3, kv_block_size=8, prefill_chunk=8,
              greedy_tie_eps=TIE_EPS)
    ref_eng = RefEngine(cfg, params, **kw)
    eng = ServingEngine(pcfg, pparams, device="cpu", **kw)
    flips = 0
    for prompt in _prompts(cfg)[0]:
        rs, rl = ref_eng.prefill_into_slot(prompt)
        ps, pl = eng.prefill_into_slot(prompt)
        pos = len(prompt)
        for _ in range(8):
            rl, pl = np.asarray(rl, np.float32), np.asarray(pl, np.float32)
            gap = float(np.abs(rl - pl).max())
            assert gap <= LOGIT_ATOL
            assert rl.argmax() == pl.argmax()
            tok = _tie_pick(rl, TIE_EPS)
            if _tie_pick(pl, TIE_EPS) != tok:
                below = rl.max() - rl
                assert np.abs(below - TIE_EPS).min() < gap
                flips += 1
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
    assert 1 <= flips <= 2


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_paged_mode_prefix_store_and_paged_prefill_refused(arch):
    """As the reference: paged block storage raises ``ValueError`` for a
    non-positional cache (the KV pool, the engine, the launcher), the
    prefix store raises when asked for directly, the engine leaves
    ``prefix_cache`` as ``None``, and ``prefill_step`` and a paged
    ``decode_step`` raise."""
    from repro.configs import get_smoke_config
    from repro.serving.kvcache import PagedKVCache as RefKV
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as PT
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.kvcache import PagedKVCache
    cfg = port_smoke_config(arch)
    with pytest.raises(ValueError):
        RefKV(get_smoke_config(arch), 2, 32, block_size=8, paged=True)
    with pytest.raises(ValueError, match="non-positional"):
        PagedKVCache(cfg, 2, 32, block_size=8, paged=True, device="cpu")
    with pytest.raises(ValueError, match="non-positional"):
        PagedKVCache(cfg, 2, 32, block_size=8, prefix_blocks=4,
                     device="cpu")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="non-positional"):
        ServingEngine(cfg, params, max_seq_len=32, paged=True,
                      device="cpu")
    eng = ServingEngine(cfg, params, max_seq_len=32, max_slots=2,
                        prefix_cache_blocks=32, device="cpu")
    assert eng.prefix_cache is None and eng.kv.prefix_pool is None
    assert not eng.kv.supports_prefix_cache
    with pytest.raises(ValueError, match="non-positional"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--paged", "--requests", "1", "--max-new", "1"])
    one = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="positional"):
        PT.prefill_step(params, cfg, {
            "tokens": one, "positions": one[:, 0], "q_lens": one[:, 0] + 4,
            "cache": eng.kv.cache, "block_tables": one})
    with pytest.raises(ValueError, match="positional"):
        PT.decode_step(params, cfg, {
            "tokens": one[:, :1], "positions": one[:, 0],
            "cache": eng.kv.cache, "block_tables": one})


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_slot_state_layout_and_reuse(arch):
    """State leaves have a batch axis and no sequence axis;
    ``write_prefill`` copies a slot's whole state, so a reused slot holds
    exactly its new owner's state and nothing of the last; ``kv_bytes``
    counts the state leaves and equals the reference's."""
    from repro.configs import get_smoke_config
    from repro.serving.kvcache import PagedKVCache as RefKV
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.models import transformer as PT
    from repro_torch.serving.kvcache import PagedKVCache, _leaves
    cfg = port_smoke_config(arch).with_(kv_cache_dtype="int8")
    kv = PagedKVCache(cfg, 3, 32, block_size=8, device="cpu")
    leaves = dict(_leaves(kv.cache))
    for (path, t), bax, sax in zip(_leaves(kv.cache), kv._axes,
                                   kv._seq_axes):
        assert t.shape[bax] == 3, path
        assert (sax is None) == (path[-1] in ("ssm", "conv")), path
    assert kv.kv_bytes() == sum(t.numel() * t.element_size()
                                for t in leaves.values())
    assert kv.kv_bytes() == RefKV(get_smoke_config(arch).with_(
        kv_cache_dtype="int8"), 3, 32, block_size=8).kv_bytes()
    g = torch.Generator().manual_seed(0)

    def filled():
        one = PT.init_cache(cfg, 1, 32)
        for _, t in _leaves(one):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
        return one

    first, second = filled(), filled()
    slot, *others = (kv.alloc_slot(20) for _ in range(3))
    kv.write_prefill(slot, first)
    kv.free_slot(slot)
    reused = kv.alloc_slot(9)                  # the one free slot
    assert reused == slot
    kv.write_prefill(reused, second)
    for (path, t), (_, want), ax in zip(_leaves(kv.cache), _leaves(second),
                                        kv._axes):
        assert torch.equal(t.select(ax, reused), want.select(ax, 0)), path
        for o in others:
            assert not t.select(ax, o).any(), path


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_launcher_serves_dense_on_cpu(arch, tmp_path):
    import json
    from repro_torch.launch import serve
    out = tmp_path / "m.json"
    gw = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-new", "4",
                     "--shared-prefix", "8", "--greedy",
                     "--prefill-token-budget", "16",
                     "--metrics-json", str(out)])
    eng = gw.replicas[0].scheduler.engine
    assert not eng.paged and eng.prefix_cache is None
    assert sorted(eng.programs) == ["decode_step", "prefill_chunk"]
    stats = json.loads(out.read_text())
    assert stats["totals"]["requests_completed"] == 3
    assert stats["totals"]["total_new_tokens"] == 12
