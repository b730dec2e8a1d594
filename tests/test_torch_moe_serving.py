"""The moe family served: the port's ``Scheduler`` + ``ServingEngine``
(``device="cpu"``) against the reference's on the same bridged weights
and the same requests, greedy.

- greedy tokens identical to the reference engine's **in the same mode**
  (paged, dense bf16, dense int8; the reference's own dense-vs-paged MoE
  case is red at raw argmax, ``tests/test_batched_prefill.py``), at
  tie-eps 1e-2, for the qwen3-moe and dbrx smoke configs, with the prefix
  cache and budgeted (interleaved) prefill; every control-flow counter
  equal, every round fed exactly the reference's token ids, positions
  and ``q_len``s in every row (padding tokens, idle decode slots and
  ``q_len = 0`` rows take expert capacity too), and nothing leaked;
- a workload whose paged prefill tiles overflow an expert's capacity
  (capacity factor 0.5: 16 slots an expert against 64 tile tokens x 2
  choices / 4 experts), so that the padding tokens of a tile (token 0 past
  ``q_len``, and ``q_len = 0`` rows) take capacity from real tokens, as in
  the reference: the tokens must still be identical, and drops must have
  happened;
- the round programs: two per engine, each built once, every round a
  replay, and a row that finishes in one prefill round sampled after the
  next round ran (its logits cloned);
- the launcher serves ``--arch qwen3-moe-30b-a3b --smoke`` paged and
  dense on the CPU.

On the card (``gpu``): a replayed MoE decode round, paged and dense int8,
is identical to an eager ``decode_step`` on the same inputs and cache."""
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
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                 ServingEngine)

torch.set_num_threads(2)

TIE_EPS = 1e-2
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]


def _bridged(arch, **over):
    cfg = get_smoke_config(arch).with_(**over)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, port_smoke_config(arch).with_(**over), params, \
        bridge.from_flat(flat)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return request.param, _bridged(request.param)


def _prompts(vocab, lengths, shared=0, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n,
                                                 dtype=np.int32)])
            for n in lengths]


def _record_ref_rounds(eng, rounds):
    """Every round's inputs the reference engine hands its jitted
    programs, as ``(program, tokens, positions[, q_lens])``."""
    step, paged, chunk = eng._step, getattr(eng, "_prefill_paged", None), \
        eng._prefill_chunk

    def step_(params, batch):
        rounds.append(("decode_step", np.asarray(batch["tokens"]).ravel(),
                       np.asarray(batch["positions"])))
        return step(params, batch)

    def paged_(params, toks, starts, qlens, *rest):
        rounds.append(("prefill_paged", np.asarray(toks).ravel(),
                       np.asarray(starts), np.asarray(qlens)))
        return paged(params, toks, starts, qlens, *rest)

    def chunk_(params, toks, cache, pos, *rest):
        rounds.append(("prefill_chunk", np.asarray(toks).ravel(),
                       np.asarray(pos)))
        return chunk(params, toks, cache, pos, *rest)

    eng._step, eng._prefill_paged, eng._prefill_chunk = step_, paged_, chunk_


def _record_port_rounds(eng, rounds):
    """The same for the port: what each round program is fed (a dense
    chunk's positions run from its start)."""
    program = eng._program

    def program_(name):
        prog = program(name)
        if not getattr(prog, "_recorded", False):
            feed = prog.feed

            def feed_(**kw):
                pos = kw["positions"]
                rec = (name, np.asarray(kw["tokens"]).ravel(),
                       pos[:1] if name == "prefill_chunk" else pos)
                rounds.append(rec + ((kw["q_lens"],) if "q_lens" in kw
                                     else ()))
                return feed(**kw)

            prog.feed, prog._recorded = feed_, True
        return prog

    eng._program = program_


def _count_advance_rounds(eng):
    """Wrap ``eng.advance_prefill`` to record, per call, how many prefill
    rounds it replayed and how many cursors it finished."""
    calls = []
    inner = eng.advance_prefill

    def advance(*a, **kw):
        before = sum(p.replays for n, p in eng.programs.items()
                     if n != "decode_step")
        done = inner(*a, **kw)
        after = sum(p.replays for n, p in eng.programs.items()
                    if n != "decode_step")
        calls.append((after - before, len(done)))
        return done

    eng.advance_prefill = advance
    return calls


def _serve(engine_cls, sched_cls, req_cls, sp_cls, cfg, params, prompts,
           max_new, engine_kw, sched_kw, rounds):
    eng = engine_cls(cfg, params, **engine_kw)
    if engine_cls is RefEngine:
        _record_ref_rounds(eng, rounds)
    else:
        _record_port_rounds(eng, rounds)
        eng.advance_calls = _count_advance_rounds(eng)
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
        pc.evict(kv.prefix_pool.num_blocks)
        assert kv.prefix_pool.in_use == 0


def _both(cfg, pcfg, params, pparams, prompts, max_new, engine_kw,
          sched_kw):
    ref_rounds, rounds = [], []
    ref, ref_sched = _serve(RefEngine, RefScheduler, RefRequest,
                            RefSamplingParams, cfg, params, prompts, max_new,
                            engine_kw, sched_kw, ref_rounds)
    ours, sched = _serve(ServingEngine, Scheduler, Request, SamplingParams,
                         pcfg, pparams, prompts, max_new,
                         dict(engine_kw, device="cpu"), sched_kw, rounds)
    # every row of every round runs the MoE block and takes expert
    # capacity: padding tokens, idle decode slots and q_len = 0 rows must
    # carry the reference's token ids and positions
    assert len(rounds) == len(ref_rounds)
    for got, want in zip(rounds, ref_rounds):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert ours == ref
    assert [len(o) for o in ours] == list(max_new)
    # identical tokens => identical control flow
    for name in ("preemptions", "admission_stalls"):
        assert getattr(sched, name) == getattr(ref_sched, name)
    for name in ("prefill_tokens", "prefill_tokens_executed",
                 "cached_prefix_tokens", "decode_steps"):
        assert getattr(sched.engine, name) == getattr(ref_sched.engine, name)
    _assert_no_leaks(sched)
    return sched


MODES = {
    "paged": dict(paged=True, prefill_batch=3, prefill_chunk=8),
    "dense-bf16": dict(paged=False, prefill_chunk=8),
    "dense-int8": dict(paged=False, prefill_chunk=8),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_greedy_tokens_match_reference(weights, mode):
    """Five requests, a 12-token shared prefix, the prefix cache on and a
    two-round prefill budget, each mode against the same mode of the
    reference."""
    arch, (cfg, pcfg, params, pparams) = weights
    if mode == "dense-int8":
        cfg, pcfg = (c.with_(kv_cache_dtype="int8") for c in (cfg, pcfg))
    prompts = _prompts(cfg.vocab_size, (3, 15, 1, 9, 6), shared=12)
    engine_kw = dict(max_seq_len=48, max_slots=3, kv_block_size=8,
                     prefix_cache_blocks=8, greedy_tie_eps=TIE_EPS,
                     **MODES[mode])
    sched = _both(cfg, pcfg, params, pparams, prompts, (5, 3, 6, 4, 4),
                  engine_kw, dict(prefill_token_budget=16))
    assert sched.metrics.prefix_hits > 0


def test_paged_tiles_that_overflow_expert_capacity_match_reference(
        monkeypatch):
    """Capacity factor 0.5 at qwen3-moe smoke width: a (4, 16) prefill
    tile routes 128 (token, choice) slots to 4 experts of 16 slots each,
    so tokens drop, and a tile's padding tokens (token 0 after each
    row's ``q_len``, whole ``q_len = 0`` rows) compete with the real ones
    in the sort.  The port must feed those rows exactly the reference's
    tokens and positions to give the same drops and the same tokens."""
    arch = "qwen3-moe-30b-a3b"
    cfg, pcfg, params, pparams = _bridged(arch, moe_capacity_factor=0.5)
    assert PM.expert_capacity(64, pcfg) == 16
    drops = []
    inner = PM._dispatch_indices

    def counting(eidx, capacity):
        out = inner(eidx, capacity)
        drops.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(PM, "_dispatch_indices", counting)
    # ragged prompts: rows finish mid-tile (padding tokens) and the last
    # rounds run with fewer prompts than rows (q_len = 0 rows)
    prompts = _prompts(cfg.vocab_size, (37, 5, 22, 50, 9), seed=8)
    engine_kw = dict(max_seq_len=80, max_slots=4, kv_block_size=8,
                     paged=True, prefill_batch=4, prefill_chunk=16,
                     greedy_tie_eps=TIE_EPS)
    _both(cfg, pcfg, params, pparams, prompts, (4, 6, 3, 5, 4), engine_kw,
          {})
    assert sum(drops) > 0


def test_round_programs_capture_once_and_replay_every_round():
    """The MoE engine's programs on their static buffers: two programs an
    engine, each built once, every round a replay, and a row finished in
    a call's first prefill round sampled after its second round ran (the
    reference's tokens all the same)."""
    cfg, pcfg, params, pparams = _bridged("qwen3-moe-30b-a3b")
    prompts = _prompts(cfg.vocab_size, (5, 22, 3, 13, 9), seed=5)
    max_new = (5, 3, 6, 4, 4)
    for paged, prefill in ((True, "prefill_paged"),
                           (False, "prefill_chunk")):
        engine_kw = dict(max_seq_len=48, max_slots=3, kv_block_size=8,
                         paged=paged, prefill_batch=1, prefill_chunk=8,
                         prefix_cache_blocks=8, greedy_tie_eps=TIE_EPS)
        sched = _both(cfg, pcfg, params, pparams, prompts, max_new,
                      engine_kw, dict(prefill_token_budget=16))
        eng = sched.engine
        # the alias case ran: a call that finished a row also replayed
        # again before the scheduler sampled that row
        assert any(rounds >= 2 and done >= 1
                   for rounds, done in eng.advance_calls), eng.advance_calls
        assert sorted(eng.programs) == sorted(["decode_step", prefill])
        assert all(p.captures == 1 for p in eng.programs.values())
        assert eng.programs["decode_step"].replays == eng.decode_steps
        assert (eng.programs[prefill].replays * 8
                == eng.prefill_tokens_executed)
        rc = eng.recompiles
        assert all(len(rc.signatures[n]) == 1 for n in eng.programs)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_launcher_serves_moe_on_cpu(paged):
    from repro_torch.launch import serve
    argv = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new", "4", "--shared-prefix", "16",
            "--greedy", "--prefill-token-budget", "32"]
    gw = serve.main(argv + (["--paged"] if paged else []))
    sched = gw.replicas[0].scheduler
    assert sched.metrics.summary()["requests_completed"] == 4
    assert sched.metrics.prefix_hits > 0
    _assert_no_leaks(sched)
    eng = sched.engine
    assert eng.params["layers"]["moe"]["router"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("paged,kv_dtype", [(True, "bfloat16"),
                                            (False, "int8")],
                         ids=["paged", "dense-int8"])
def test_cuda_replayed_moe_decode_round_equals_eager(cuda, paged, kv_dtype):
    from repro_torch.serving.kvcache import _leaves
    cfg = port_smoke_config("qwen3-moe-30b-a3b").with_(
        kv_cache_dtype=kv_dtype)
    params = PT.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    eng = ServingEngine(cfg, params, max_seq_len=64, max_slots=4,
                        kv_block_size=16, paged=paged, prefill_batch=2,
                        device=cuda)
    prompts = _prompts(cfg.vocab_size, (9, 30, 17), seed=11)
    tokens = np.zeros(4, np.int32)
    positions = np.zeros(4, np.int32)
    for p, (slot, last) in zip(prompts, eng.prefill_into_slots(prompts)):
        tokens[slot] = int(np.argmax(last))
        positions[slot] = len(p)
        eng.kv.ensure_capacity(slot, len(p) + 1)
    before = [t.clone() for _, t in _leaves(eng.kv.cache)]
    replayed = eng.decode_once(tokens, positions).clone()
    assert eng.programs["decode_step"].captures == 1
    for (_, t), b in zip(_leaves(eng.kv.cache), before):
        t.copy_(b)
    batch = {"tokens": torch.from_numpy(tokens[:, None]).to(cuda),
             "positions": torch.from_numpy(positions).to(cuda),
             "cache": eng.kv.cache}
    if paged:
        batch["block_tables"] = eng.kv.device_block_tables()
    eager = PT.decode_step(eng.params, cfg, batch)[0][:, 0]
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
