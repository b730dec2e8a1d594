"""The per-layer metrics read from the program's span recorder: each
reader on a hand-made summary of a session, and None on an empty one, in
a run with no traced slice, and where the program has no recorder."""
import builtins

import pytest

from chipbench import core, program_spans
import chipbench_cpu as C

SESSION = {
    "spans": 40, "units": 12, "busy_s": 1.2,
    "idle_s": {"serve.gateway_step": 0.01, "serve.step": 0.02,
               "serve.admit": 0.03, "serve.decode.build": 0.04,
               "serve.retire": 0.05, "serve.prefill": 0.06,
               "serve.prefill.build": 0.07, "serve.prefill.feed": 0.08,
               "serve.prefill.replay": 0.09, "serve.decode.feed": 0.10,
               "serve.decode.replay": 0.11, "serve.sample": 0.12,
               "serve.sample.first": 0.13, "caller": 0.14},
    "device_s": {"train.grads": 3.0, "train.reduce": 0.5,
                 "train.update": 0.5},
    "replays": {"prefill_paged": [4, 0.02], "decode_step": [5, 0.03]},
    "marks": {"queue_wait_ms": [float(v) for v in range(1, 12)],
              "prefill_latency_ms": [100.0, 200.0]}}
CTX = {"trace": {"window_s": 2.0, "busy_s": 1.0}}
# by hand: each layer's idle seconds over the 2 s slice
WANT = {"idle_share.serve.scheduler": 100 * (0.01 + 0.02 + 0.03 + 0.04
                                              + 0.05) / 2,
        "idle_share.serve.staging": 100 * (0.06 + 0.07 + 0.08 + 0.09
                                            + 0.10 + 0.11) / 2,
        "idle_share.serve.sampling": 100 * (0.12 + 0.13) / 2,
        "idle_share.serve.caller": 100 * 0.14 / 2,
        "queue_wait_p90_ms": 10.0,          # rank 9 of 1..11
        "prefill_latency_p90_ms": 190.0,    # 100 + 0.9 * 100
        "prefill_replay_ms": 5.0, "decode_replay_ms": 6.0,
        "update_share.train": 12.5}


def _reader(name):
    return core.load_module(C.ROOT / "chipbench" / "layer_metrics"
                            / f"{name}.py", name)


def test_readers_by_hand(monkeypatch):
    monkeypatch.setattr(program_spans, "session",
                        lambda ctx: SESSION if ctx.get("trace") else {})
    for name, want in WANT.items():
        assert _reader(name).read(CTX) == pytest.approx(want), name
    four = sum(WANT[f"idle_share.serve.{k}"] for k in program_spans.LAYERS)
    assert four == pytest.approx(100 * sum(SESSION["idle_s"].values()) / 2)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_finds_nothing_in_an_empty_session(monkeypatch, name):
    monkeypatch.setattr(program_spans, "session", lambda ctx: {})
    assert _reader(name).read(CTX) is None


def test_no_traced_slice_and_no_recorder_read_nothing(monkeypatch):
    assert program_spans.session({"window_s": 1.0}) == {}
    real = builtins.__import__

    def no_recorder(name, *a, **k):
        if name == "repro_torch.core.spans":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_recorder)
    assert program_spans.session(CTX) == {}
    for name in WANT:
        assert _reader(name).read(CTX) is None


def test_entries_list_their_cells():
    b = core.benchmark(C.ROOT)
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == (["qwen2-0.5b.train"] if name.endswith(
            ".train") else ["qwen2-0.5b.clients64"])
