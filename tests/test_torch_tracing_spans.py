"""The span recorder (``repro_torch.core.spans``) in the serving and the
training steps.

- Under ``torch.profiler`` (CPU activities), one gateway step of a smoke
  paged engine records the serving span tree (``serve.gateway_step`` >
  ``serve.step`` > its phases > the engine's per-round spans), every span
  with its parent, and the profiler's events hold the ``serve.*`` ranges.
- Outside a profiler, with the Tracer off, nothing is recorded and no
  span object or ``record_function`` range is made.
- The gap arithmetic on hand-made spans and device units: each split
  worked out by hand, the parts summing to the idle.
- A smoke train step records ``train.grads``, ``train.reduce`` and
  ``train.update``, each a device unit.
- The per-request readings equal the metrics' own (queue wait).
- ``Scheduler(profile=True)`` synchronises nothing and feeds its
  profiler from the recorder; an enabled Tracer's ``engine_step`` events
  carry the device fields and the Chrome export a "device" thread, and
  the trace passes the reference's ``trace_report.py --validate``.
- On the card (``gpu``): a step's device units are ordered on the
  device's clock, its gaps are non-negative, and nothing synchronises
  beyond the step's read-backs.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.spans as spans_mod
from repro_torch.configs import get_smoke_config
from repro_torch.core.spans import CALLER, SPANS, SpanRecorder, split_idle
from repro_torch.models import transformer as T
from repro_torch.serving import (ReplicaGateway, Request, SamplingParams,
                                 Scheduler, ServingEngine, Tracer)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

SERVE_PARENTS = {
    "serve.step": "serve.gateway_step", "serve.admit": "serve.step",
    "serve.prefill": "serve.step", "serve.prefill.build": "serve.prefill",
    "serve.prefill.feed": "serve.prefill",
    "serve.prefill.replay": "serve.prefill",
    "serve.sample.first": "serve.prefill",
    "serve.decode.build": "serve.step", "serve.decode.feed": "serve.step",
    "serve.decode.replay": "serve.step", "serve.sample": "serve.step",
    "serve.retire": "serve.step"}


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def _engine(smoke, device="cpu"):
    cfg, params = smoke
    return ServingEngine(cfg, params, max_seq_len=64, max_slots=4,
                         kv_block_size=8, prefill_chunk=8, prefill_batch=2,
                         paged=True, device=device)


def _requests(cfg, n, seed=0, lens=(5, 7, 6, 9, 4, 8), max_new=4):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, lens[i % len(lens)],
                                 dtype=np.int64).astype(np.int32),
                    SamplingParams(max_new_tokens=max_new, greedy=True))
            for i in range(n)]


def _new_session(rec=SPANS):
    """Start the next recording on a fresh session."""
    rec.live = False


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Leave no session behind for other tests in this process."""
    yield
    SPANS.live = False
    SPANS._reset()


def test_profiler_records_the_serving_span_tree(smoke):
    cfg, _ = smoke
    gw = ReplicaGateway.from_engines([_engine(smoke)],
                                     prefill_token_budget=16)
    for r in _requests(cfg, 2):
        gw.submit(r)
    _new_session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gw.step()                 # both prompts finish their prefill here
    names = [s.name for s in SPANS.spans]
    assert names[0] == "serve.gateway_step"
    assert set(names) == set(SERVE_PARENTS) | {"serve.gateway_step"}
    for s in SPANS.spans:
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.name == "serve.gateway_step":
            assert s.parent is None and s.depth == 0
        else:
            assert s.parent.name == SERVE_PARENTS[s.name]
            assert s.depth == s.parent.depth + 1
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
    step = [s for s in SPANS.spans if s.name == "serve.step"][0].step
    assert all(s.step == step for s in SPANS.spans if s.depth > 0)
    ranges = {e.name for e in prof.events()}
    assert set(SERVE_PARENTS) <= ranges and "serve.gateway_step" in ranges
    got = SPANS.summary()
    assert got["spans"] == len(names)
    assert got["replays"]["prefill_paged"][0] == names.count(
        "serve.prefill.replay")
    assert got["replays"]["decode_step"][0] == 1
    assert len(got["marks"]["queue_wait_ms"]) == 2
    assert len(got["marks"]["prefill_latency_ms"]) == 2


def test_off_records_nothing_and_builds_nothing(smoke, monkeypatch):
    cfg, _ = smoke
    gw = ReplicaGateway.from_engines([_engine(smoke)],
                                     prefill_token_budget=16)
    for r in _requests(cfg, 3):
        gw.submit(r)

    def refuse(*a, **k):
        raise AssertionError("made while recording is off")

    before = list(SPANS.spans)
    monkeypatch.setattr(spans_mod._ap, "record_function", refuse)
    monkeypatch.setattr(spans_mod.Span, "__init__", refuse)
    monkeypatch.setattr(spans_mod.Unit, "__init__", refuse)
    assert not SPANS.driven
    while gw.step():
        pass
    assert list(SPANS.spans) == before and not SPANS.pending
    assert not SPANS.live


def _span(name, depth, start, end, parent=None):
    return SimpleNamespace(name=name, depth=depth, start_ns=start,
                           end_ns=end, parent=parent)


def test_split_idle_by_hand():
    spans = [_span("A", 0, 0, 100), _span("B", 1, 10, 40),
             _span("C", 2, 20, 30), _span("D", 1, 60, 90),
             _span("E", 0, 130, None)]              # still open
    got = split_idle(spans, 5, 95)
    assert got == [("A", 5, 10), ("B", 10, 20), ("C", 20, 30),
                   ("B", 30, 40), ("A", 40, 60), ("D", 60, 90),
                   ("A", 90, 95)]
    assert sum(b - a for _, a, b in got) == 90
    assert split_idle(spans, 95, 150) == [("A", 95, 100), (CALLER, 100, 130),
                                          ("E", 130, 150)]
    assert split_idle(spans, 50, 50) == []


def test_settle_gaps_by_hand():
    """CPU units (host times are device times): the gap before each unit
    is the host time since the previous one ended, split over the
    innermost spans; each unit's time goes to the span it started in."""
    rec = SpanRecorder()
    rec.live = True
    a0, a1 = _span("A", 0, 0, 100), _span("A", 0, 100, 200)
    for s in [a0, _span("B", 1, 10, 40, a0), _span("C", 1, 50, 80, a0),
              a1, _span("D", 1, 150, 190, a1)]:
        rec.spans.append(s)
    cpu = torch.device("cpu")
    for name, span, t0, t1, prog in [("u1", "B", 12, 30, "p"),
                                     ("u2", "C", 55, 70, None),
                                     ("u3", "D", 160, 170, "p")]:
        u = spans_mod.Unit(name, span, prog, cpu)
        u.t_start_ns, u.t_end_ns = t0, t1
        rec.pending.append(u)
    got = rec.settle()
    # u1 is the first: no gap before it.  u2: [30, 55) = B 30-40, A 40-50,
    # C 50-55.  u3: [70, 160) = C 70-80, A 80-100, A 100-150, D 150-160.
    by_hand = {"B": 10, "A": 10 + 20 + 50, "C": 5 + 10, "D": 10}
    assert got["idle_by_span"] == {k: v / 1e9 for k, v in by_hand.items()}
    assert got["idle_s"] == pytest.approx(sum(by_hand.values()) / 1e9)
    assert got["busy_s"] == pytest.approx((18 + 15 + 10) / 1e9)
    assert [u[0] for u in got["units"]] == ["u1", "u2", "u3"]
    s = rec.summary()
    assert s["idle_s"] == got["idle_by_span"]
    assert s["device_s"] == {k: v / 1e9 for k, v in
                             {"B": 18, "C": 15, "D": 10}.items()}
    assert s["replays"] == {"p": [2, 28 / 1e9]}
    assert SpanRecorder().summary() == {}


def test_train_step_records_its_three_phases():
    from repro_torch import optim
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    cfg = get_smoke_config("qwen2-0.5b").with_(dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    with hvd.init("cpu") as dev:
        groups = hvd.axis_groups({"data": 1})
        opt = optim.adamw(1e-3, clip_norm=1.0)
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               weight_dtype=torch.float32)
        state = opt.init(params)
        step = stepfn.make_train_step(cfg, opt, groups, device=dev)
        step(params, state, {"tokens": toks, "labels": toks})
        _new_session()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, state, {"tokens": toks, "labels": toks})
    phases = ["train.grads", "train.reduce", "train.update"]
    assert [s.name for s in SPANS.spans] == phases
    assert {e.name for e in prof.events()} >= set(phases)
    got = SPANS.summary()
    assert got["units"] == 3 and set(got["device_s"]) == set(phases)
    assert all(v > 0 for v in got["device_s"].values())


def test_queue_wait_marks_are_the_metrics_own(smoke):
    cfg, _ = smoke
    gw = ReplicaGateway.from_engines([_engine(smoke)],
                                     prefill_token_budget=16)
    metrics = gw.replicas[0].scheduler.metrics
    _new_session()
    with profile(activities=[ProfilerActivity.CPU]):
        for r in _requests(cfg, 6):
            gw.submit(r)
        while gw.step():
            pass
    got = SPANS.summary()["marks"]
    assert got["queue_wait_ms"] == list(metrics.queue_wait_ms.ring)
    assert len(got["queue_wait_ms"]) == 6
    # first admit -> first token, one per request; on the CPU every
    # request's prefill takes at least one round
    assert len(got["prefill_latency_ms"]) == 6
    assert all(v > 0 for v in got["prefill_latency_ms"])


def test_profile_true_synchronises_nothing(smoke, monkeypatch):
    """``profile=True`` drives the recorder (its tracer off): no
    synchronise, and each step feeds the profiler its phases' device time
    and its idle."""
    cfg, _ = smoke

    def refuse(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not hasattr(Scheduler, "_sync")
    sched = Scheduler(_engine(smoke), prefill_token_budget=16,
                      profile=True)
    assert not sched.tracer.enabled and sched.records_spans
    for r in _requests(cfg, 3):
        sched.submit(r)
    sched.run()
    s = sched.profiler.summary()
    assert s["steps"] == sched.tracer.current_step > 0
    assert set(s) == {"steps", "admit_ms", "prefill_ms", "decode_ms",
                      "sample_ms", "idle_ms"}
    assert s["decode_ms"]["max"] > 0 and s["prefill_ms"]["max"] > 0
    assert s["sample_ms"]["max"] > 0


def test_tracer_timeline_device_thread_and_validation(smoke, tmp_path):
    from repro_torch.serving.tracing import to_chrome_trace
    cfg, _ = smoke
    gw = ReplicaGateway.from_engines([_engine(smoke)], tracing=True,
                                     prefill_token_budget=16)
    for r in _requests(cfg, 3):
        gw.submit(r)
    while gw.step():
        pass
    steps = [ev for ev in gw.trace_events() if ev["kind"] == "engine_step"]
    assert steps and all("dev_busy_s" in ev for ev in steps)
    labels = set(SERVE_PARENTS) | {"serve.gateway_step", CALLER}
    for ev in steps:
        assert set(ev["dev_idle_by_span"]) <= labels
        assert ev["dev_idle_s"] == pytest.approx(
            sum(ev["dev_idle_by_span"].values()))
        assert sum(b - a for _, a, b in ev["dev_gaps"]) == pytest.approx(
            ev["dev_idle_s"])
        assert ev["dev_busy_s"] == pytest.approx(
            sum(b - a for _, _, a, b in ev["dev_units"]))


    chrome = to_chrome_trace({"replica0": gw.tracers[0].snapshot()})
    dev = [e for e in chrome["traceEvents"]
           if e.get("tid") == 2 and e["ph"] == "X"]
    assert {e["name"] for e in dev} >= {"decode_step", "prefill_paged"}
    assert any(e["name"].startswith("idle: ") for e in dev)
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "scripts" / "trace_report.py")
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    path = gw.export_trace_jsonl(tmp_path / "t.jsonl")
    assert tr.main(["--validate", str(path)]) == 0


@pytest.mark.gpu
def test_cuda_step_units_are_ordered_without_extra_syncs(smoke,
                                                         monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = smoke
    dev = torch.device("cuda")
    eng = ServingEngine(cfg, {k: v for k, v in params.items()},
                        max_seq_len=64, max_slots=4, kv_block_size=16,
                        prefill_chunk=16, prefill_batch=2, paged=True,
                        device=dev)
    eng.warm_up()
    tracer = Tracer(enabled=True)
    sched = Scheduler(eng, prefill_token_budget=32, tracer=tracer)
    for r in _requests(cfg, 4, lens=(20, 30, 9, 40), max_new=6):
        sched.submit(r)
    sched.step()                        # warm the sampling kernels
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(1), real(*a, **k)))
    n0 = len(tracer.events)
    while sched.has_work:
        sched.step()
    assert not calls
    steps = [ev for ev in list(tracer.events)[n0:]
             if ev["kind"] == "engine_step" and "dev_units" in ev]
    assert len(steps) >= 5
    units = [u for ev in steps for u in ev["dev_units"]]
    for (_, _, a0, b0), (_, _, a1, b1) in zip(units, units[1:]):
        assert a0 <= b0 <= a1 + 1e-6 and a1 <= b1
    for ev in steps:
        assert ev["dev_idle_s"] >= 0 and all(
            b >= a for _, a, b in ev["dev_gaps"])
        assert ev["dev_busy_s"] > 0
