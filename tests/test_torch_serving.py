"""Serving: the port's Scheduler + ServingEngine(paged=True, device="cpu")
against the reference's on the same bridged weights and the same
requests, greedy.  Tokens must be identical — with the engine's default
``greedy_tie_eps=1e-2`` for qwen2 smoke and raw argmax (``0.0``) for
gemma2 smoke, as the reference's own dense-vs-paged test does for that
family — and the port must leak no slot, block or prefix pin."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.models import transformer as T
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import Scheduler as RefScheduler
from repro.serving import ServingEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                 ServingEngine)

torch.set_num_threads(2)

TIE_EPS = {"qwen2-0.5b": 1e-2, "gemma2-2b": 0.0}


@pytest.fixture(scope="module", params=["qwen2-0.5b", "gemma2-2b"])
def weights(request):
    cfg = get_smoke_config(request.param)
    # jitted: the same weights as eager init, compiled once
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return request.param, cfg, params, bridge.from_flat(flat)


def _prompts(vocab, lengths, shared=0, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n,
                                                 dtype=np.int32)])
            for n in lengths]


def _serve(engine_cls, sched_cls, req_cls, sp_cls, cfg, params, prompts,
           max_new, engine_kw, sched_kw):
    eng = engine_cls(cfg, params, **engine_kw)
    sched = sched_cls(eng, **sched_kw)
    rids = [sched.submit(req_cls(p, sp_cls(max_new_tokens=m, greedy=True)))
            for p, m in zip(prompts, max_new)]
    sched.run()
    return [sched.output(r).tolist() for r in rids], sched


def _assert_no_leaks(sched):
    kv = sched.engine.kv
    assert not (sched.queue or sched.active or sched.prefilling)
    assert kv.free_slot_count == kv.max_slots
    assert kv.pool.in_use == 0
    assert not sched.engine._inflight
    pc = sched.engine.prefix_cache
    if pc is not None:
        # every request retired: evicting the tree must free every block,
        # or a request's pin leaked
        pc.evict(kv.prefix_pool.num_blocks)
        assert kv.prefix_pool.in_use == 0


CASES = {
    # shared-prefix burst with the prefix cache on, budgeted (interleaved)
    # prefill, 4-row co-prefill
    "prefix_budget_batch4": dict(
        lengths=(3, 9, 1, 14, 6), shared=20, max_new=(6, 4, 7, 3, 5),
        engine=dict(prefix_cache_blocks=16, prefill_batch=4),
        sched=dict(prefill_token_budget=16)),
    # undersized KV pool: deferred admissions and decode-time preemption,
    # one-row prefill rounds
    "undersized_batch1": dict(
        lengths=(13, 21, 7, 17, 9), shared=0, max_new=(10, 8, 12, 6, 9),
        engine=dict(prefix_cache_blocks=8, prefill_batch=1, num_blocks=8),
        sched=dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_greedy_tokens_match_reference(weights, case):
    arch, cfg, params, pparams = weights
    c = CASES[case]
    prompts = _prompts(cfg.vocab_size, c["lengths"], c["shared"])
    engine_kw = dict(max_seq_len=48, max_slots=3, kv_block_size=8,
                     paged=True, greedy_tie_eps=TIE_EPS[arch], **c["engine"])
    ref, ref_sched = _serve(RefEngine, RefScheduler, RefRequest,
                            RefSamplingParams, cfg, params, prompts,
                            c["max_new"], engine_kw, c["sched"])
    ours, sched = _serve(ServingEngine, Scheduler, Request, SamplingParams,
                         port_smoke_config(arch), pparams, prompts,
                         c["max_new"], dict(engine_kw, device="cpu"),
                         c["sched"])
    assert ours == ref
    assert [len(o) for o in ours] == list(c["max_new"])
    # identical tokens => identical control flow
    assert sched.preemptions == ref_sched.preemptions
    assert sched.admission_stalls == ref_sched.admission_stalls
    assert sched.engine.prefill_tokens == ref_sched.engine.prefill_tokens
    assert (sched.engine.cached_prefix_tokens
            == ref_sched.engine.cached_prefix_tokens)
    if case == "undersized_batch1":
        assert sched.preemptions > 0
    else:
        assert sched.metrics.prefix_hits > 0
        assert sched.metrics.budget_rounds > 0
    _assert_no_leaks(sched)


def test_engine_rejects_what_later_slices_port():
    cfg = port_smoke_config("qwen2-0.5b")
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, {}, max_seq_len=16, paged=False, device="cpu")
    moe = cfg.with_(family="moe")
    with pytest.raises(NotImplementedError):
        ServingEngine(moe, {}, max_seq_len=16, device="cpu")


def test_sampling_tie_break_and_temperature():
    """Greedy rows take the lowest id within eps of the max; rows at
    temperature < 1e-4 are greedy; other rows sample from the seeded
    generator (reproducibly, but not the reference's stream)."""
    from repro_torch.models import transformer as PT
    cfg = port_smoke_config("qwen2-0.5b")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_seq_len=16, max_slots=2,
                        kv_block_size=8, device="cpu", rng_seed=5)
    logits = torch.full((3, 10), -5.0)
    logits[:, 7] = 1.0
    logits[:, 4] = 1.0 - 5e-3                  # within eps of the max
    logits[:, 2] = 1.0 - 2e-2                  # outside eps
    toks = eng.sample_tokens(logits, np.array([1.0, 0.0, 1.0], np.float32),
                             np.array([True, False, True]))
    assert toks.tolist() == [4, 4, 4]
    eng.greedy_tie_eps = 0.0
    assert eng.sample_tokens(logits, np.ones(3, np.float32),
                             np.ones(3, bool)).tolist() == [7, 7, 7]
    flat = torch.zeros((2, 10))
    draws = [eng.sample_tokens(flat, np.ones(2, np.float32),
                               np.zeros(2, bool)).tolist()
             for _ in range(20)]
    assert len({t for d in draws for t in d}) > 3     # it samples


def test_launcher_serves_and_traces_in_the_reference_schema(tmp_path):
    """The port's launcher on the CPU: every request completes, the
    metrics JSON lands, and every trace event passes the reference's
    schema check (the port keeps ``EVENT_KINDS`` identical)."""
    import json

    from repro.serving.tracing import EVENT_KINDS as REF_KINDS
    from repro.serving.tracing import validate_event
    from repro_torch.launch import serve
    from repro_torch.serving.tracing import EVENT_KINDS

    assert EVENT_KINDS == REF_KINDS
    sched = serve.main([
        "--arch", "gemma2-2b", "--smoke", "--paged", "--device", "cpu",
        "--requests", "5", "--max-new", "4", "--shared-prefix", "16",
        "--greedy", "--prefill-token-budget", "32", "--profile",
        "--metrics-json", str(tmp_path / "m.json"),
        "--trace-out", str(tmp_path / "t")])
    stats = json.loads((tmp_path / "m.json").read_text())
    assert stats["summary"]["requests_completed"] == 5
    assert stats["summary"]["prefix_cache"]["hits"] > 0
    _assert_no_leaks(sched)
    events = [json.loads(line) for line in
              (tmp_path / "t.jsonl").read_text().splitlines()]
    assert events and all(validate_event(ev) is None for ev in events)
    assert (tmp_path / "t.chrome.json").exists()
