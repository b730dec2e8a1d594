"""The check against the reference sees each fault a cell can have.

Each test drives a whole run on the CPU at the port's smoke size (the look
for a card skipped), the program in f32 (its KV cache stays bf16) so
that sound runs read near rounding, with the timed path broken underneath, and sees ``correct``
come out false; the same run unbroken comes out true.  The control (the
reference in float8) reads above the same limits."""
import pytest
import torch

from chipbench.reference import train as rtrain
from repro_torch.distributed import stepfn
from repro_torch.serving.engine import ServingEngine
import chipbench_cpu as C

# sound runs read 0.00027-0.00064 here (the KV cache is bf16 whatever the
# compute dtype), the float8 control 0.0038-0.0103 (seeds 21-24, 16 sampled
# requests, 6-12 tokens each)
SERVE_LIMIT = 0.002
TRAIN_LIMITS = {"grad_gap": 1e-3, "change_gap": 1e-3}


def _f32(cell):
    cell.config["port"]["overrides"]["dtype"] = "float32"


def _serve(cell):
    _f32(cell)
    cell.spec["check"] = dict(cell.spec["check"], mean_gap=SERVE_LIMIT,
                              requests=16)


def _train(cell):
    _f32(cell)
    cell.spec["check"] = dict(cell.spec["check"], **TRAIN_LIMITS)


def serve_run(seconds=2.0):
    return C.run_smoke("qwen2-0.5b.clients64", seed=21,
                       seconds=seconds, hook=_serve)


def train_run():
    return C.run_smoke("qwen2-0.5b.train", seed=22, seconds=0.3,
                       hook=_train)


def test_sound_runs_are_correct():
    assert serve_run()["correct"]
    res = train_run()
    assert res["correct"], res["checks"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    plain = ServingEngine.sample_tokens
    calls = [0]

    def altered(self, logits, temps, greedy):
        toks = plain(self, logits, temps, greedy)
        calls[0] += 1
        if calls[0] % 7 == 0:
            toks = (toks + 1) % self.cfg.vocab_size
        return toks
    monkeypatch.setattr(ServingEngine, "sample_tokens", altered)
    res = serve_run()
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > SERVE_LIMIT


def test_a_decode_step_that_leaves_its_state_unchanged(monkeypatch):
    plain = ServingEngine.decode_once

    def stateless(self, tokens, positions):
        leaves = _kv_leaves(self)
        saved = [t.clone() for t in leaves]
        out = plain(self, tokens, positions)
        for t, s in zip(leaves, saved):
            t.copy_(s)
        return out
    monkeypatch.setattr(ServingEngine, "decode_once", stateless)
    assert not serve_run()["correct"]


def _kv_leaves(engine):
    from repro_torch.serving.kvcache import _leaves
    return [t for _, t in _leaves(engine.kv.cache)]


def test_half_of_the_decode_batch_left_out(monkeypatch):
    plain = ServingEngine.decode_once

    def half(self, tokens, positions):
        out = plain(self, tokens, positions)
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(ServingEngine, "decode_once", half)
    assert not serve_run()["correct"]


def _wrap_step(monkeypatch, make):
    plain = stepfn.make_train_step

    def build(*a, **k):
        return make(plain(*a, **k))
    monkeypatch.setattr(stepfn, "make_train_step", build)


def test_a_train_step_that_returns_its_state_unchanged(monkeypatch):
    def make(step):
        def frozen(params, state, batch):
            snap = [t.clone() for t in _tensors((params, state))]
            params, state, m = step(params, state, batch)
            for t, s in zip(_tensors((params, state)), snap):
                t.copy_(s)
            return params, state, m
        return frozen
    _wrap_step(monkeypatch, make)
    res = train_run()
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def _tensors(tree):
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_half_of_the_batch_left_out_the_mean_over_the_rest(monkeypatch):
    def make(step):
        def half(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})
        return half
    _wrap_step(monkeypatch, make)
    res = train_run()
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > TRAIN_LIMITS["grad_gap"]


def test_the_float8_control_reads_above_the_limits(monkeypatch):
    from chipbench import core
    mod = core.load_module(C.ROOT / "chipbench" / "traffic"
                           / "serve_closed_loop.py", "serve_closed_loop")
    plain_logits = mod.reference_logits
    seen = {}

    def with_control(params, config, seqs, dev, precision="f32"):
        out = plain_logits(params, config, seqs, dev, precision)
        ctl = plain_logits(params, config, seqs, dev, "fp8")
        seen["gap"] = mod.served_numbers(
            out, [c.argmax(dim=-1) for c in ctl])["mean_gap"]
        return out
    monkeypatch.setattr(mod, "reference_logits", with_control)
    assert serve_run()["correct"]
    assert seen["gap"] > SERVE_LIMIT

    plain_readings = rtrain.readings

    def control(params0, cfg, batches, opt, **kw):
        r = plain_readings(params0, cfg, batches, opt, **kw)
        c = plain_readings(params0, cfg, batches, opt,
                           **dict(kw, precision="fp8"))
        got = rtrain.compare(c, r)
        seen["train"] = [got[k] / TRAIN_LIMITS[k] for k in TRAIN_LIMITS]
        return r
    monkeypatch.setattr(rtrain, "readings", control)
    assert train_run()["correct"]
    assert max(seen["train"]) > 1.0, seen["train"]
