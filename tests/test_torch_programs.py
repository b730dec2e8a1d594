"""The engine's round programs (``repro_torch.serving.programs``): the
port's counterpart of the reference engine's jitted programs.

On the CPU a ``CapturedProgram`` runs its body on every call, on the same
static inputs and into the same static output as a captured graph
replays, so these tests hold the static-buffer path to the reference:

- greedy tokens through the ``Scheduler`` identical to the reference
  engine's on bridged weights, at each family's tie-eps (qwen2 smoke
  1e-2, gemma2 smoke raw argmax), paged (qwen2 and gemma2 smoke) and
  dense with the bf16 and the int8 KV cache (qwen2 smoke), and dense
  for the recurrent families (mamba2 smoke at 1e-2, zamba2 smoke with
  the bf16 and the int8 cache at raw argmax), with
  interleaved prefill in which a row finishes in one prefill round and
  another round runs before it is sampled (the prefill output it was read
  from is overwritten by then);
- the scheduler samples each decode round's logits before the next
  decode round overwrites them;
- after warm-up, more rounds make no new signature and no post-warm
  recompile, and each engine holds exactly its two programs, each built
  once;
- ``device_block_tables`` is one tensor refreshed in place; a rebound KV
  leaf is refused; the dense staging stripe parks a cursor left
  mid-prompt and restores it bit for bit, the recurrent state of the
  mamba2 and zamba2 layers included;
- a program adds what its build launched to the kernel counters once per
  call.

On the card (``gpu``): a replayed decode round, paged and dense int8
(qwen2), dense mamba2 and dense int8 zamba2, is identical to an eager
``decode_step`` on the same inputs and the same cache with the same
kernels; a capture against a block-table tensor that is then rebound
fails that comparison; a body the card cannot capture raises."""
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
from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import transformer as PT
from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                 ServingEngine)
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.programs import CapturedProgram

torch.set_num_threads(2)

# zamba2 at raw argmax: at 1e-2 its smoke runs meet a reference margin at
# the tie rule's boundary (``test_torch_ssm_serving.py``, KNOWN_GAPS)
TIE_EPS = {"qwen2-0.5b": 1e-2, "gemma2-2b": 0.0, "mamba2-1.3b": 1e-2,
           "zamba2-1.2b": 0.0}


def _bridged(arch):
    cfg = get_smoke_config(arch)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, params, bridge.from_flat(flat)


@pytest.fixture(scope="module")
def qwen2():
    return _bridged("qwen2-0.5b")


def _prompts(vocab, lengths, shared=0, seed=5):
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


# The alias cases: one-row rounds (paged) or one cursor per chunk (dense)
# with a budget of two rounds, and a short prompt first, so a row finishes
# in a call's first round and the second round replays before the
# scheduler samples it.
ALIAS_CASES = {
    ("paged", "qwen2-0.5b", "bfloat16"): dict(
        engine=dict(paged=True, prefill_batch=1, prefill_chunk=8,
                    kv_block_size=8, prefix_cache_blocks=8),
        budget=16),
    ("paged", "gemma2-2b", "bfloat16"): dict(
        engine=dict(paged=True, prefill_batch=1, prefill_chunk=8,
                    kv_block_size=8, prefix_cache_blocks=8),
        budget=16),
    ("dense", "qwen2-0.5b", "bfloat16"): dict(
        engine=dict(prefill_chunk=8, kv_block_size=8,
                    prefix_cache_blocks=8),
        budget=16),
    ("dense", "qwen2-0.5b", "int8"): dict(
        engine=dict(prefill_chunk=8, kv_block_size=8,
                    prefix_cache_blocks=8),
        budget=16),
    # the recurrent families: prefix blocks asked for, none kept
    ("dense", "mamba2-1.3b", "bfloat16"): dict(
        engine=dict(prefill_chunk=8, kv_block_size=8,
                    prefix_cache_blocks=8),
        budget=16),
    ("dense", "zamba2-1.2b", "bfloat16"): dict(
        engine=dict(prefill_chunk=8, kv_block_size=8,
                    prefix_cache_blocks=8),
        budget=16),
    ("dense", "zamba2-1.2b", "int8"): dict(
        engine=dict(prefill_chunk=8, kv_block_size=8,
                    prefix_cache_blocks=8),
        budget=16),
}


@pytest.mark.parametrize("mode,arch,kv_dtype", sorted(ALIAS_CASES))
def test_greedy_tokens_match_reference_through_the_programs(
        qwen2, mode, arch, kv_dtype):
    cfg, params, pparams = qwen2 if arch == "qwen2-0.5b" else _bridged(arch)
    c = ALIAS_CASES[mode, arch, kv_dtype]
    cfg = cfg.with_(kv_cache_dtype=kv_dtype)
    pcfg = port_smoke_config(arch).with_(kv_cache_dtype=kv_dtype)
    prompts = _prompts(cfg.vocab_size, (5, 22, 3, 13, 9), shared=0)
    max_new = (5, 3, 6, 4, 4)
    engine_kw = dict(max_seq_len=48, max_slots=3,
                     greedy_tie_eps=TIE_EPS[arch], **c["engine"])
    sched_kw = dict(prefill_token_budget=c["budget"])
    ref, _ = _serve(RefEngine, RefScheduler, RefRequest, RefSamplingParams,
                    cfg, params, prompts, max_new, engine_kw, sched_kw)
    eng = ServingEngine(pcfg, pparams, device="cpu", **engine_kw)
    calls = _count_advance_rounds(eng)
    sched = Scheduler(eng, **sched_kw)
    rids = [sched.submit(Request(p, SamplingParams(max_new_tokens=m,
                                                   greedy=True)))
            for p, m in zip(prompts, max_new)]
    sched.run()
    ours = [sched.output(r).tolist() for r in rids]
    assert ours == ref
    # the alias case ran: a call that finished a row also replayed again
    assert any(rounds >= 2 and done >= 1 for rounds, done in calls), calls
    prefill = "prefill_paged" if mode == "paged" else "prefill_chunk"
    assert sorted(eng.programs) == sorted(["decode_step", prefill])
    assert all(p.captures == 1 for p in eng.programs.values())
    assert eng.programs["decode_step"].replays == eng.decode_steps
    per_round = c["engine"]["prefill_chunk"] * (
        c["engine"]["prefill_batch"] if mode == "paged" else 1)
    assert (eng.programs[prefill].replays * per_round
            == eng.prefill_tokens_executed)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_scheduler_samples_each_decode_round_before_the_next(qwen2, paged):
    """Every decode replay's logits reach ``sample_tokens`` before the
    next decode replay overwrites them (version counter of the static
    output), with interleaved prefill rounds in between."""
    _, _, pparams = qwen2
    eng = ServingEngine(port_smoke_config("qwen2-0.5b"), pparams,
                        max_seq_len=48, max_slots=3, kv_block_size=8,
                        prefill_chunk=8, paged=paged, prefill_batch=2,
                        device="cpu")
    events = []
    replay = CapturedProgram.replay

    def traced_replay(prog):
        out = replay(prog)
        if prog.name == "decode_step":
            events.append(("decode", out._version))
        return out

    sample = eng.sample_tokens

    def traced_sample(logits, temps, greedy):
        dec = eng.programs.get("decode_step")
        if (dec is not None and dec.output is not None
                and logits.data_ptr() == dec.output.data_ptr()):
            events.append(("sample", logits._version))
        return sample(logits, temps, greedy)

    eng.sample_tokens = traced_sample
    sched = Scheduler(eng, prefill_token_budget=8)
    for p in _prompts(256, (5, 17, 2, 11)):
        sched.submit(Request(p, SamplingParams(max_new_tokens=5,
                                               greedy=True)))
    mp = pytest.MonkeyPatch()
    mp.setattr(CapturedProgram, "replay", traced_replay)
    try:
        sched.run()
    finally:
        mp.undo()
    pending = None
    for kind, version in events:
        if kind == "decode":
            assert pending is None, "a decode round overwrote unsampled logits"
            pending = version
        else:
            assert version == pending, "sampled logits of another round"
            pending = None
    assert pending is None
    assert sum(k == "decode" for k, _ in events) == eng.decode_steps > 3


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_no_new_signature_after_warm_up(qwen2, paged):
    _, _, pparams = qwen2
    eng = ServingEngine(port_smoke_config("qwen2-0.5b"), pparams,
                        max_seq_len=48, max_slots=3, kv_block_size=8,
                        prefill_chunk=8, paged=paged, prefill_batch=2,
                        prefix_cache_blocks=8, device="cpu")
    sched = Scheduler(eng, prefill_token_budget=16)

    def burst(seed):
        for p in _prompts(256, (4, 19, 9, 2), shared=8, seed=seed):
            sched.submit(Request(p, SamplingParams(max_new_tokens=4,
                                                   greedy=True)))
        sched.run()

    burst(0)
    rc = eng.recompiles
    rc.mark_warm()
    programs = dict(eng.programs)
    sigs = {n: set(rc.signatures[n]) for n in programs}
    replays = {n: p.replays for n, p in programs.items()}
    burst(1)
    # (eager sampling's signature follows how many rows finish together,
    # in the reference too; only the round programs have fixed shapes)
    assert all(rc.post_warm.get(n, 0) == 0 for n in programs)
    assert {n: rc.signatures[n] for n in programs} == sigs
    assert all(len(s) == 1 for s in sigs.values())
    assert eng.programs == programs and len(programs) == 2
    assert all(p.captures == 1 for p in programs.values())
    assert all(p.replays > replays[n] for n, p in programs.items())


def test_device_block_tables_is_one_tensor_refreshed_in_place():
    cfg = port_smoke_config("qwen2-0.5b")
    kv = PagedKVCache(cfg, max_slots=3, max_seq_len=32, block_size=8,
                      paged=True, device="cpu")
    buf = kv.device_block_tables()
    trash = kv.trash_block
    assert (buf == trash).all()
    a = kv.alloc_slot(10)                       # 2 blocks
    b = kv.alloc_slot(3)
    got = kv.device_block_tables()
    assert got is buf
    assert got[a, :2].tolist() == kv.block_table[a]
    assert got[b, :1].tolist() == kv.block_table[b]
    assert (got[a, 2:] == trash).all() and (got[b, 1:] == trash).all()
    assert kv.device_block_tables(mask_slots=[a]) is buf
    assert (buf[a] == trash).all() and buf[b, 0] == kv.block_table[b][0]
    kv.ensure_capacity(b, 12)                   # grow: a ledger change
    assert kv.device_block_tables(mask_slots={a: None}) is buf
    assert buf[b, :2].tolist() == kv.block_table[b] and (buf[a] == trash).all()
    kv.free_slot(b)
    assert kv.device_block_tables() is buf
    assert buf[a, :2].tolist() == kv.block_table[a] and (buf[b] == trash).all()
    np.testing.assert_array_equal(buf.numpy(), kv._tables)


def test_a_rebound_kv_leaf_is_refused(qwen2):
    _, _, pparams = qwen2
    eng = ServingEngine(port_smoke_config("qwen2-0.5b"), pparams,
                        max_seq_len=32, max_slots=2, kv_block_size=8,
                        paged=True, device="cpu")
    eng.decode_once(np.zeros(2, np.int32), np.zeros(2, np.int32))
    leaves = eng.kv.cache["layers"]
    leaves["k"] = leaves["k"].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        eng.decode_once(np.zeros(2, np.int32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="static input"):
        eng.programs["decode_step"].feed(tokens=np.zeros((3, 1), np.int32))


def test_dense_stripe_parks_a_cursor_left_mid_prompt(qwen2):
    """Cursor B runs one chunk, A then claims the stripe and completes,
    then B resumes from its parked copy: both rows' last logits and slot
    KV equal those of each prompt prefilled alone on a fresh engine."""
    _, _, pparams = qwen2
    cfg = port_smoke_config("qwen2-0.5b").with_(kv_cache_dtype="int8")
    kw = dict(max_seq_len=40, max_slots=2, prefill_chunk=8, device="cpu")
    pa_, pb_ = _prompts(cfg.vocab_size, (13, 21), seed=7)
    eng = ServingEngine(cfg, pparams, **kw)
    ca, cb = eng.begin_prefill([pa_, pb_])
    assert eng.advance_prefill([cb], token_budget=8) == []
    assert eng.advance_prefill([ca]) == [ca]
    assert cb.dense_cache is not None           # parked while A ran
    assert eng.advance_prefill([cb]) == [cb]
    assert eng.programs["prefill_chunk"].captures == 1
    for prompt, cur in ((pa_, ca), (pb_, cb)):
        alone = ServingEngine(cfg, pparams, **kw)
        [c1] = alone.begin_prefill([prompt])
        alone.advance_prefill()
        assert torch.equal(c1.last_logits, cur.last_logits)
        for name, leaf in eng.kv.cache["layers"].items():
            assert torch.equal(leaf[:, :, cur.slot],
                               alone.kv.cache["layers"][name][:, :, c1.slot])


@pytest.mark.parametrize("arch,kv_dtype", [("mamba2-1.3b", "bfloat16"),
                                           ("zamba2-1.2b", "int8")])
def test_dense_stripe_parks_a_recurrent_state_left_mid_prompt(arch,
                                                              kv_dtype):
    """As above for the recurrent families: the parked copy is the whole
    SSM and conv state (and zamba2's shared-block K/V), so B resumes bit
    for bit; every slot leaf, whatever its batch axis, equals the prompt
    prefilled alone, and nothing leaks."""
    from repro_torch.serving.kvcache import _leaves
    _, _, pparams = _bridged(arch)
    cfg = port_smoke_config(arch).with_(kv_cache_dtype=kv_dtype)
    kw = dict(max_seq_len=40, max_slots=2, prefill_chunk=8, device="cpu")
    pa_, pb_ = _prompts(cfg.vocab_size, (13, 21), seed=7)
    eng = ServingEngine(cfg, pparams, **kw)
    ca, cb = eng.begin_prefill([pa_, pb_])
    assert eng.advance_prefill([cb], token_budget=8) == []
    assert eng.advance_prefill([ca]) == [ca]
    assert cb.dense_cache is not None           # parked while A ran
    assert eng.advance_prefill([cb]) == [cb]
    assert eng.programs["prefill_chunk"].captures == 1
    for prompt, cur in ((pa_, ca), (pb_, cb)):
        alone = ServingEngine(cfg, pparams, **kw)
        [c1] = alone.begin_prefill([prompt])
        alone.advance_prefill()
        assert torch.equal(c1.last_logits, cur.last_logits)
        for (path, leaf), (_, other), ax in zip(
                _leaves(eng.kv.cache), _leaves(alone.kv.cache),
                eng.kv._axes):
            assert torch.equal(leaf.select(ax, cur.slot),
                               other.select(ax, c1.slot)), path
        alone.free_slot(c1.slot)
    for cur in (ca, cb):
        eng.free_slot(cur.slot)
    assert eng.kv.free_slot_count == 2 and eng.kv.pool.in_use == 0
    assert not eng._inflight


def test_program_adds_its_build_launches_once_per_call():
    """A stub body that bumps two kernel counters as a wrapper would
    (three and one launches at its first run, other counts later): every
    call adds the first run's counts, as a graph replay (which runs no
    Python) must."""
    saved = _build.launch_counts()
    calls = []

    def body(x):
        n = len(calls)
        calls.append(n)
        rn.rmsnorm.launches += 3 + n
        pa.paged_attention.launches += 1 + 2 * n
        return x * 2

    try:
        _build.set_launch_counts(dict.fromkeys(saved, 0))
        prog = CapturedProgram("stub", body, {"x": torch.zeros(4)})
        for i in range(5):
            prog.feed(x=np.full(4, i, np.float32))
            out = prog.replay()
            assert out is prog.output and out.tolist() == [2.0 * i] * 4
        assert prog.launches == {"rmsnorm": 3, "paged_attention": 1}
        assert prog.captures == 1 and prog.replays == 5
        counts = _build.launch_counts()
        assert counts["rmsnorm"] == 15 and counts["paged_attention"] == 5
        assert all(v == 0 for k, v in counts.items()
                   if k not in ("rmsnorm", "paged_attention"))
    finally:
        _build.set_launch_counts(saved)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(cfg, n, seed=12):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) for _ in range(n)]


def _card_engine(arch, kv_dtype, paged, dev):
    cfg = port_smoke_config(arch).with_(kv_cache_dtype=kv_dtype)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    eng = ServingEngine(cfg, params, max_seq_len=64, max_slots=4,
                        kv_block_size=16, paged=paged, prefill_batch=2,
                        device=dev)
    prompts = _prompts(cfg.vocab_size, (9, 30, 17), seed=11)
    frames = _frames(cfg, 3) if cfg.family == "encdec" else None
    tokens = np.zeros(4, np.int32)
    positions = np.zeros(4, np.int32)
    for p, (slot, last) in zip(prompts, eng.prefill_into_slots(prompts,
                                                               frames)):
        tokens[slot] = int(np.argmax(last))
        positions[slot] = len(p)
        eng.kv.ensure_capacity(slot, len(p) + 1)
    return eng, tokens, positions


def _eager_decode(eng, tokens, positions):
    dev = eng.device
    batch = {"tokens": torch.from_numpy(tokens[:, None]).to(dev),
             "positions": torch.from_numpy(positions).to(dev),
             "cache": eng.kv.cache}
    if eng.paged:
        batch["block_tables"] = eng.kv.device_block_tables()
    if eng._enc_pool is not None:
        batch["encoder_output"] = eng._enc_pool
    return PT.decode_step(eng.params, eng.cfg, batch)[0][:, 0]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_encdec_rounds_read_the_encoder_pool_in_place(kv_dtype):
    """whisper smoke, dense: each request's encoder output lands in its
    slot's row of the pool at admission (equal to ``_encode`` of its
    frames); the pool and the batch-1 staging row keep their addresses
    across prompt chunks and decode rounds; the last chunk read the slot's
    row; a decode round through the program equals an eager
    ``decode_step`` given the whole pool, from the same cache."""
    from repro_torch.serving.kvcache import _leaves
    eng, tokens, positions = _card_engine("whisper-small", kv_dtype, False,
                                          torch.device("cpu"))
    pool, enc1 = eng._enc_pool, eng._enc1
    ptrs = (pool.data_ptr(), enc1.data_ptr())
    cfg = eng.cfg
    frames = _frames(cfg, 3)
    with torch.no_grad():
        want = PT._encode(eng.params["encoder"], cfg,
                          torch.from_numpy(np.stack(frames)))
    slots = sorted(np.flatnonzero(positions).tolist())
    assert len(slots) == 3
    for i, slot in enumerate(slots):
        assert torch.equal(pool[slot], want[i])
    assert torch.equal(enc1[0], pool[slots[-1]])
    before = [t.clone() for _, t in _leaves(eng.kv.cache)]
    replayed = eng.decode_once(tokens, positions).clone()
    for (_, t), b in zip(_leaves(eng.kv.cache), before):
        t.copy_(b)
    eager = _eager_decode(eng, tokens, positions)
    assert torch.equal(replayed, eager)
    for _ in range(3):
        eng.decode_once(tokens, positions)
        positions[slots] += 1
    eng.prefill_into_slot(_prompts(cfg.vocab_size, (5,), seed=2)[0],
                          _frames(cfg, 1, seed=3)[0])
    assert (eng._enc_pool.data_ptr(), eng._enc1.data_ptr()) == ptrs
    progs = eng.programs
    assert sorted(progs) == ["decode_step", "prefill_chunk"]
    assert all(p.captures == 1 for p in progs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,paged,kv_dtype", [
    ("qwen2-0.5b", True, "bfloat16"), ("qwen2-0.5b", False, "int8"),
    ("mamba2-1.3b", False, "bfloat16"), ("zamba2-1.2b", False, "int8"),
    ("whisper-small", False, "bfloat16"), ("whisper-small", False, "int8")],
    ids=["paged", "dense-int8", "mamba2-dense", "zamba2-dense-int8",
         "whisper-dense", "whisper-dense-int8"])
def test_cuda_replayed_decode_round_equals_eager(cuda, arch, paged,
                                                 kv_dtype):
    """The replayed round and an eager ``decode_step`` from the same
    cache: the cache is snapshotted before each replay and restored
    before the eager step (a mamba layer's state advances a token a
    step; attention K/V are rewritten with the same values)."""
    from repro_torch.serving.kvcache import _leaves
    eng, tokens, positions = _card_engine(arch, kv_dtype, paged, cuda)
    before = [t.clone() for _, t in _leaves(eng.kv.cache)]

    def restore():
        for (_, t), b in zip(_leaves(eng.kv.cache), before):
            t.copy_(b)

    replayed = eng.decode_once(tokens, positions).clone()
    prog = eng.programs["decode_step"]
    assert prog.captures == 1 and prog.replays == 1
    restore()
    eager = _eager_decode(eng, tokens, positions)
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    after = [t.clone() for _, t in _leaves(eng.kv.cache)]
    restore()
    again = eng.decode_once(tokens, positions)
    assert prog.captures == 1 and torch.equal(again, eager)
    assert all(torch.equal(t, a)
               for (_, t), a in zip(_leaves(eng.kv.cache), after))


@pytest.mark.gpu
def test_cuda_replay_with_a_rebound_block_table_fails_the_check(cuda):
    """Capture, then rebind the cache's block table to a new tensor and
    free a slot: the new table maps that row to the trash block, the
    replay still reads the captured tensor, and the eager-versus-replay
    comparison must catch it."""
    eng, tokens, positions = _card_engine("qwen2-0.5b", "bfloat16", True,
                                          cuda)
    eng.decode_once(tokens, positions)
    kv = eng.kv
    kv.block_tables_dev = kv.block_tables_dev.clone()
    kv.free_slot(min(kv.block_table))
    replayed = eng.decode_once(tokens, positions).clone()
    eager = _eager_decode(eng, tokens, positions)
    torch.cuda.synchronize()
    assert eng.programs["decode_step"].captures == 1
    assert not torch.equal(replayed, eager)


@pytest.mark.gpu
def test_cuda_capture_failure_raises(cuda):
    def body(x):
        # a constant made from a Python value per call: a copy from
        # pageable host memory, which a capture forbids
        return x * torch.tensor(2.0, device=x.device)

    prog = CapturedProgram("sync", body, {"x": torch.ones(4, device=cuda)})
    with pytest.raises(RuntimeError, match="capture"):
        prog.replay()
    assert prog.captures == 0
