"""The vlm family (qwen2-vl-72b smoke: the dense stack with stub patch
embeddings prepended to the text, M-RoPE, QKV bias, an untied head), the
port against the reference on the same bridged weights and the same numpy
inputs: ``input_specs`` / ``synthesize_inputs``, ``apply_rope`` with 3-D
positions, ``forward``, the two losses (the patch positions dropped),
gradients against ``jax.grad``, ``decode_step`` with and without
``mrope_positions``, paged prefill and decode, greedy tokens through
``Scheduler`` paged and dense against the reference engine's, the train
launcher's batch, and remat.

Tolerances, and why:
- RoPE f32 atol 1e-5 (the same products; cos and sin from another
  library, observed 2.4e-7); logits f32 atol 1e-5 (observed 2.7e-6);
- bf16 logits atol 1e-2 plus one bf16 ulp of the logit (2^-7 |logit|):
  the untied head rounds its logits to bf16, as the reference's does, and
  a one-ulp flip in the final hidden state (9 of the smoke forward's
  6,144 hidden values, where random M-RoPE positions meet the patch
  rows) moves a logit of |x| in [2, 4) by 2^-6 (observed 1.56e-2);
- losses rtol 1e-5 in f32, 1e-3 in bf16;
- gradients by each leaf's relative norm error: 1e-5 in f32, 3e-2 in
  bf16 (the dense family's bounds; observed 1.2e-6 and 1.5e-2);
- greedy tokens identical at the engines' tie-eps 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"
SEQ, BATCH = 24, 2
F32_ATOL = 1e-5
LOGIT_ATOL = {"bfloat16": 1e-2, "float32": 1e-5}
LOGIT_RTOL = {"bfloat16": 2.0 ** -7, "float32": 0.0}
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-5}
GRAD_RTOL = {"bfloat16": 3e-2, "float32": 1e-5}
TIE_EPS = 1e-2


def _flat_np(tree):
    from repro.checkpoint.ckpt import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def vlm():
    from repro.configs import get_smoke_config
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config as port_smoke_config
    cfg = get_smoke_config(ARCH)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    P = cfg.num_patches
    batch = {
        "patch_embeddings": (0.02 * rng.standard_normal(
            (BATCH, P, cfg.d_model))).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ - P),
                               dtype=np.int32),
        "mrope_positions": rng.integers(0, SEQ, (3, BATCH, SEQ),
                                        dtype=np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                               dtype=np.int32)}
    return (cfg, port_smoke_config(ARCH), params,
            bridge.from_flat(_flat_np(params)), batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-small",
                                  "qwen2-0.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    """``input_specs`` gives the reference's keys, shapes and dtypes
    (the decode cache included); ``synthesize_inputs`` fills them in the
    reference's integer ranges (ids below the vocab, positions below the
    sequence length), drawn from its generator."""
    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape as RefShape
    from repro.configs.base import input_specs as ref_specs
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.configs.base import (InputShape, input_specs,
                                          synthesize_inputs)
    cfg, pcfg = get_smoke_config(arch), port_smoke_config(arch)
    S, B = 24, 3
    want = _flat_np(jax.tree.map(
        lambda s: np.zeros(s.shape, np.dtype(s.dtype)),
        ref_specs(cfg, RefShape("t", S, B, kind))))
    shape = InputShape("t", S, B, kind)
    got = synthesize_inputs(pcfg, shape, torch.Generator().manual_seed(5))
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(p, v)
            else:
                flat[p] = v
    walk("", got)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert tuple(flat[k].shape) == v.shape, k
        assert str(flat[k].dtype).replace("torch.", "") == str(v.dtype), k
    for k, t in flat.items():
        if not t.dtype.is_floating_point and not k.startswith("cache"):
            hi = cfg.vocab_size if ("token" in k or "label" in k) else S
            assert 0 <= int(t.min()) and int(t.max()) < hi, k
    assert input_specs(pcfg, shape)["tokens"][0] == want["tokens"].shape
    again = synthesize_inputs(pcfg, shape, torch.Generator().manual_seed(5))
    assert torch.equal(again["tokens"], got["tokens"])


def test_vlm_tree_layout(vlm):
    """The port's own init has the reference's keys and shapes: the dense
    layout (layers stacked (L, 1, ...)), QKV biases, an untied lm_head."""
    from repro_torch import bridge
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, _, _ = vlm
    ref = _flat_np(params)
    ours = bridge.to_flat(PT.init_params(
        pcfg, torch.Generator().manual_seed(0), weight_dtype=torch.bfloat16))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
    assert ours["layers/attn/wq/w"].shape[:2] == (cfg.num_layers, 1)
    assert ours["lm_head/w"].shape == (cfg.d_model, cfg.vocab_size)


@settings(max_examples=25, deadline=None)
@given(split=st.lists(st.integers(0, 16), min_size=2, max_size=2),
       seed=st.integers(0, 2 ** 16))
def test_mrope_matches_reference(split, seed):
    """``apply_rope`` with (3, B, S) positions against the reference's for
    any split of head_dim/2 = 16 into (t, h, w) sections (empty ones
    included), in f32 and bf16; with (B, S) positions it is plain RoPE
    whatever the sections."""
    from repro.models import attention as A
    from repro_torch.models import attention as PA
    a, b = sorted(split)
    sections = (a, b - a, 16 - b)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 5), dtype=np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = A.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e6,
                            sections)
        got = PA.apply_rope(torch.from_numpy(x).to(dt),
                            torch.from_numpy(pos), 1e6, sections)
        w = np.asarray(want, np.float32)
        if dt == torch.float32:
            np.testing.assert_allclose(got.numpy(), w, atol=F32_ATOL,
                                       rtol=0)
        else:
            np.testing.assert_allclose(got.float().numpy(), w, rtol=8e-3,
                                       atol=2.0 ** -9)
    plain = PA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                          1e6, sections)
    torch.testing.assert_close(plain, PA.apply_rope(
        torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6))
    same = PA.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.broadcast_to(pos[:1], pos.shape).copy()), 1e6, sections)
    torch.testing.assert_close(same, plain)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_losses_match_reference(vlm, dtype):
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = vlm
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    jb, tb = _jb(batch), _tb(batch)
    want, _ = jax.jit(lambda p, b: T.forward(p, cfg, b))(params, jb)
    want_l, _ = jax.jit(lambda p, b: T.lm_loss(p, cfg, b))(params, jb)
    want_c, _ = jax.jit(lambda p, b: T.lm_loss_chunked(
        p, cfg, b, seq_chunk=8))(params, jb)
    with torch.no_grad():
        got, aux = PT.forward(pparams, pcfg, tb)
        got_l, _ = PT.lm_loss(pparams, pcfg, tb)
        got_c, _ = PT.lm_loss_chunked(pparams, pcfg, tb, seq_chunk=8)
        # the loss reads the text positions alone: other labels under
        # the patches change nothing
        tb2 = dict(tb, labels=tb["labels"].clone())
        tb2["labels"][:, :cfg.num_patches] = 0
        got_l2, _ = PT.lm_loss(pparams, pcfg, tb2)
    assert got.shape == (BATCH, SEQ, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL[dtype],
                               rtol=LOGIT_RTOL[dtype])
    for g, w in ((got_l, want_l), (got_c, want_c)):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL[dtype])
    assert float(got_l2) == float(got_l)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grads_match_reference(vlm, dtype):
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.distributed import stepfn
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, batch = vlm
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
            for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[dtype], (worst, errs[worst])


def test_remat_is_bitwise(vlm):
    """remat on against remat off, bf16: the same loss and gradients, bit
    for bit."""
    from repro_torch.distributed import stepfn
    from repro_torch.models import transformer as PT
    from repro_torch.optim import tree_map
    _, pcfg, _, pparams, batch = vlm
    out = []
    for remat in (True, False):
        c = pcfg.with_(remat=remat)
        out.append(stepfn.value_and_grad(
            lambda p, b: PT.lm_loss(p, c, b), pparams, _tb(batch)))
    assert torch.equal(out[0][0], out[1][0])
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             out[0][2], out[1][2])


@pytest.mark.parametrize("mrope", [True, False], ids=["mrope", "plain"])
def test_decode_steps_match_reference(vlm, mrope):
    """Eight dense-cache ``decode_step``s, bf16, with (3, B, 1)
    ``mrope_positions`` (each section its own position) or without them
    (the engine's text serving: plain RoPE at ``positions``), logits
    within 1e-2 plus one ulp at every step."""
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, _ = vlm
    B, S = BATCH, 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    mpos = rng.integers(0, 64, (3, B, S), dtype=np.int32)
    jc = T.init_cache(cfg, B, S + 4)
    tc = PT.init_cache(pcfg, B, S + 4)
    step = jax.jit(T.decode_step, static_argnums=1)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jb = {"tokens": jnp.asarray(toks[:, t:t + 1]),
              "positions": jnp.asarray(pos), "cache": jc}
        tb = {"tokens": torch.from_numpy(toks[:, t:t + 1]),
              "positions": torch.from_numpy(pos), "cache": tc}
        if mrope:
            jb["mrope_positions"] = jnp.asarray(mpos[:, :, t:t + 1])
            tb["mrope_positions"] = torch.from_numpy(
                np.ascontiguousarray(mpos[:, :, t:t + 1]))
        jl, jc = step(params, cfg, jb)
        tl, tc = PT.decode_step(pparams, pcfg, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL["bfloat16"],
                                   rtol=LOGIT_RTOL["bfloat16"])


def test_paged_prefill_and_decode_match_reference(vlm):
    """Paged storage (vlm has a positional cache): two prefill tiles
    (ragged q_lens) then three decode steps through the block tables,
    against the reference's, logits within 1e-2 plus one ulp."""
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, _ = vlm
    rng = np.random.default_rng(11)
    B, C, bs, nb = 3, 8, 8, 12
    shape = (cfg.num_layers, 1, nb + 1, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jc = {"layers": {n: jnp.zeros(shape, jnp.bfloat16) for n in "kv"}}
    tc = {"layers": {n: torch.zeros(shape, dtype=torch.bfloat16)
                     for n in "kv"}}
    tables = rng.permutation(nb)[:B * 4].reshape(B, 4).astype(np.int32)
    starts = np.zeros(B, np.int32)
    kw = dict(atol=LOGIT_ATOL["bfloat16"], rtol=LOGIT_RTOL["bfloat16"])
    for ql in (np.array([8, 5, 8], np.int32), np.array([3, 0, 8], np.int32)):
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
                **kw)
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
                                   **kw)
        starts = starts + 1


MODES = {"paged": dict(paged=True, prefill_batch=3, prefill_chunk=8),
         "dense": dict(paged=False, prefill_chunk=8)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_greedy_tokens_match_reference(vlm, mode):
    """Text serving, as the reference's engine serves the vlm family (no
    patches, plain RoPE): five requests, a 12-token shared prefix, the
    prefix cache on, a two-round prefill budget, each mode against the
    same mode of the reference at tie-eps 1e-2: the same tokens and
    counters, prefix hits, nothing leaked."""
    from repro.serving import Request as RefRequest
    from repro.serving import SamplingParams as RefSP
    from repro.serving import Scheduler as RefScheduler
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                     ServingEngine)
    cfg, pcfg, params, pparams, _ = vlm
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 12, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n,
                                                    dtype=np.int32)])
               for n in (3, 15, 1, 9, 6)]
    max_new = (5, 3, 6, 4, 4)
    kw = dict(max_seq_len=48, max_slots=3, kv_block_size=8,
              prefix_cache_blocks=8, greedy_tie_eps=TIE_EPS, **MODES[mode])
    runs = []
    for eng_cls, sched_cls, req, sp, c, p, extra in (
            (RefEngine, RefScheduler, RefRequest, RefSP, cfg, params, {}),
            (ServingEngine, Scheduler, Request, SamplingParams, pcfg,
             pparams, {"device": "cpu"})):
        sched = sched_cls(eng_cls(c, p, **kw, **extra),
                          prefill_token_budget=16)
        rids = [sched.submit(req(pr, sp(max_new_tokens=m, greedy=True)))
                for pr, m in zip(prompts, max_new)]
        sched.run()
        runs.append(([sched.output(r).tolist() for r in rids], sched))
    (ref, ref_sched), (ours, sched) = runs
    assert ours == ref
    assert [len(o) for o in ours] == list(max_new)
    for name in ("prefill_tokens", "prefill_tokens_executed",
                 "cached_prefix_tokens", "decode_steps"):
        assert getattr(sched.engine, name) == getattr(ref_sched.engine, name)
    assert sched.metrics.prefix_hits > 0
    kv = sched.engine.kv
    assert kv.free_slot_count == kv.max_slots and kv.pool.in_use == 0


def test_train_launcher_vlm_batch_and_cpu_run():
    """The launcher's vlm batch has ``input_specs``' keys, shapes and
    dtypes (text S - num_patches, M-RoPE positions (3, B, S), labels (B,
    S) with the text behind the patch places), and the launcher trains
    the smoke config on the CPU (no launches there)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape, input_specs
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.launch import train
    cfg = get_smoke_config(ARCH)
    P = cfg.num_patches
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 32, 2))
    b = train.family_batch(cfg, src.batch(1), 1)
    specs = input_specs(cfg, InputShape("t", 32, 2, "train"))
    assert sorted(b) == sorted(specs)
    for k, (shape, dtype) in specs.items():
        assert tuple(np.shape(b[k])) == shape, k
        assert str(torch.as_tensor(b[k]).dtype) == str(dtype), k
    np.testing.assert_array_equal(b["tokens"],
                                  src.batch(1)["tokens"][:, :32 - P])
    np.testing.assert_array_equal(b["labels"][:, P:], b["tokens"])
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "32",
                      "--global-batch", "2"])
    assert out["arch"] == "qwen2-vl-72b-smoke"
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["launches_per_step"]["flash_attention"] == [0, 0]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_donated_step_equals_the_functional_step(weight_decay):
    """``make_train_step`` updates params and AdamW state in place
    (``update_in_place``, the counterpart of the reference's donated step)
    and gives the bits of the functional update: two steps on the vlm
    smoke config with global-norm clipping against the same loss and
    gradients run through ``optimizer.update`` + ``apply_updates``;
    params, ``mu``, ``nu`` and ``count`` equal bit for bit, and the
    step's trees are the ones passed in."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import hvd
    from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
    from repro_torch.distributed import stepfn
    from repro_torch.launch.train import family_batch
    from repro_torch.models import transformer as PT
    from repro_torch.optim import tree_map
    cfg = get_smoke_config(ARCH)
    src = SyntheticTokenSource(TokenDatasetSpec(cfg.vocab_size, 24, 2))
    opt = optim.adamw(1e-3, weight_decay=weight_decay, clip_norm=0.5)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            weight_dtype=torch.float32)
    state = opt.init(params)
    ref_p = tree_map(torch.clone, params)
    ref_s = tree_map(torch.clone, state)
    with hvd.init("cpu") as dev:
        step = stepfn.make_train_step(cfg, opt, hvd.axis_groups({"data": 1}),
                                      device=dev)
        for i in range(2):
            batch = family_batch(cfg, src.batch(i), i)
            b = {k: torch.as_tensor(v) for k, v in batch.items()}
            loss, _, grads = stepfn.value_and_grad(
                lambda p, x: PT.lm_loss(p, cfg, x), ref_p, b)
            updates, ref_s = opt.update(grads, ref_s, ref_p)
            ref_p = optim.apply_updates(ref_p, updates)
            new_p, new_s, m = step(params, state, batch)
            assert new_p is params and new_s is state
            assert float(m["loss"]) == float(loss)
    assert int(state["count"]) == int(ref_s["count"]) == 2
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             ref_p, params)
    for k in ("mu", "nu"):
        tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0),
                 ref_s[k], state[k])
