"""The port's serving launcher through the fleet, its kernel profiles and
the two fleet benchmarks, on the CPU.

- ``--replicas 2 --paged`` (tenants, an SLO config, ``--metrics-out``
  re-written every ``--metrics-interval-steps`` steps, ``--trace-out``
  and ``--profile``) and ``--fabric mock --smoke``: every request
  completes, the merged totals land, and each trace passes the
  reference's ``scripts/trace_report.py --validate`` (``--fleet`` for the
  fabric's merged trace); ``--fabric`` without ``--smoke`` exits.
- ``profile_paged_kernels`` on a paged CPU engine: the reference's result
  keys (plus the device), FLOPs and bytes from ``decode_cost`` /
  ``prefill_cost``, which equal the formulas written out here.
- Both benchmarks on the CPU write their JSON with the reference's keys
  and ``bit_identical_outputs`` true.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "scripts" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_replicas_paged_metrics_and_trace(tmp_path, monkeypatch):
    from repro_torch.launch import serve
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"default": {"ttft_p95_ms": 60000.0},
                               "tenants": {"b": {"gap_p95_ms": 60000.0}}}))
    out = tmp_path / "totals.json"
    writes = []
    import repro_torch.serving as S
    real = S.atomic_write_json

    def spy(path, obj):
        writes.append(Path(path))
        return real(path, obj)

    # the launcher imports it from the package at each run
    monkeypatch.setattr(S, "atomic_write_json", spy)
    gw = serve.main([
        "--arch", "qwen2-0.5b", "--smoke", "--paged", "--device", "cpu",
        "--replicas", "2", "--requests", "6", "--max-new", "6",
        "--shared-prefix", "20", "--greedy", "--tenant", "a,b",
        "--slo-config", str(slo), "--metrics-out", str(out),
        "--metrics-interval-steps", "2", "--profile",
        "--metrics-json", str(tmp_path / "m.json"),
        "--trace-out", str(tmp_path / "t")])
    assert len(gw.replicas) == 2
    tot = json.loads(out.read_text())
    assert tot["requests_completed"] == 6 and tot["replicas"] == 2
    assert tot["total_new_tokens"] == 36
    assert set(tot["tenants"]) == {"a", "b"}
    # periodic snapshots, then the final one
    assert len([p for p in writes if p == out]) >= 2
    stats = json.loads((tmp_path / "m.json").read_text())
    assert set(stats) >= {"replicas", "totals", "fleet", "kernel_profiles"}
    for name, rep in stats["replicas"].items():
        assert "slo" in rep and "profile" in rep
        progs = rep["programs"]
        assert sorted(progs) == ["decode_step", "prefill_paged"]
        assert all(p["captures"] == 1 for p in progs.values())
        assert rep["capsule"] is None
    assert stats["fleet"]["failovers"] == 0
    assert {h["state"] for h in stats["fleet"]["health"].values()} == \
        {"healthy"}
    assert sum(r.scheduler.metrics.summary()["prefix_cache"]["hits"]
               for r in gw.replicas) > 0
    for rep in gw.replicas:
        rc = rep.scheduler.engine.recompiles.summary()
        assert rc["post_warm_recompiles"] == 0
    tr = _trace_report()
    assert tr.main(["--validate", str(tmp_path / "t.jsonl")]) == 0
    assert tr.main(["--validate", "--slo", "--profile",
                    str(tmp_path / "t.jsonl")]) == 0
    assert (tmp_path / "t.chrome.json").exists()


def test_launcher_fabric_mock_and_its_fleet_trace(tmp_path):
    from repro_torch.launch import serve
    out = tmp_path / "totals.json"
    gw = serve.main([
        "--arch", "qwen2-0.5b", "--smoke", "--fabric", "mock",
        "--device", "cpu", "--replicas", "2", "--requests", "4",
        "--max-new", "4", "--greedy", "--max-seq-len", "48",
        "--max-slots", "3", "--spool", str(tmp_path / "spool"),
        "--metrics-out", str(out), "--trace-out", str(tmp_path / "f")])
    tot = json.loads(out.read_text())
    assert tot["requests_completed"] == 4 and tot["replicas"] == 2
    backend = gw.replicas[0].scheduler.backend
    assert type(backend).__name__ == "MockBackend"
    # the CPU reached the workers through the model spec's engine kwargs
    for worker in backend.workers.values():
        assert worker.sched.engine.device.type == "cpu"
        assert worker.finished
    spec = gw.replicas[0].scheduler.spec.model_spec
    assert spec["engine"]["device"] == "cpu" and spec["config"] == \
        "qwen2-0.5b"
    tr = _trace_report()
    assert tr.main(["--validate", "--fleet", str(tmp_path / "f.jsonl")]) == 0


def test_launcher_fabric_needs_smoke():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--fabric requires --smoke"):
        serve.main(["--arch", "qwen2-0.5b", "--fabric", "local",
                    "--device", "cpu"])


def test_profile_paged_kernels_keys_and_formulas():
    """The reference's result keys on a paged CPU engine, with FLOPs and
    bytes from the port's cost formulas, which equal the work written out
    here (the engine's serving shapes: 4 slots of 128 positions, page
    16, qwen2 smoke's heads, in the engine's KV dtype: bf16, 2 bytes an
    element, against the bf16 peak)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine, profile_paged_kernels
    from repro_torch.serving import profiling as prof
    cfg = get_smoke_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_seq_len=128, max_slots=4,
                        paged=True, device="cpu")
    got = profile_paged_kernels(eng, reps=2)
    keys = {"name", "reps", "wall_ms_median", "flops", "bytes_accessed",
            "achieved_tflops", "achieved_gbps", "fraction_of_peak_flops",
            "fraction_of_peak_bw", "arithmetic_intensity"}
    assert set(got) == {"paged_attention", "paged_prefill"}
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, B, L, C, pps = H // KV, 4, 128, 8, 8
    want = {"paged_attention": (
                2 * B * H * D * 2 + B * L * KV * D * 2 * 2 + B * 4 * (1 + pps),
                4 * B * L * KV * G * D),
            "paged_prefill": (
                2 * B * C * H * D * 2 + B * C * KV * D * 2 * 2
                + B * 4 * (2 + pps),
                4 * B * sum(c + 1 for c in range(C)) * KV * G * D)}
    cases = prof.paged_profile_cases(**prof.profile_shapes(eng))
    for case in cases.values():
        assert {case[k].dtype for k in ("q", "k_pages", "v_pages")} == {
            torch.bfloat16}
    for name, p in got.items():
        assert keys <= set(p) and p["device"] == "cpu"
        assert p["name"] == name and p["reps"] == 2
        assert (p["bytes_accessed"], p["flops"]) == want[name]
        assert p["wall_ms_median"] > 0
        assert p["arithmetic_intensity"] == pytest.approx(
            p["flops"] / p["bytes_accessed"])
        assert p["fraction_of_peak_flops"] == pytest.approx(
            p["flops"] / (p["wall_ms_median"] / 1e3) / 989e12)
    assert (prof.decode_cost(cases["paged_attention"]),
            prof.prefill_cost(cases["paged_prefill"])) == \
        (want["paged_attention"], want["paged_prefill"])
    with pytest.raises(ValueError, match="paged engine"):
        profile_paged_kernels(ServingEngine(cfg, params, max_seq_len=32,
                                            device="cpu"))


def test_cost_formulas_count_the_window_and_bf16():
    """A window caps the positions read, and bf16 counts two bytes an
    element."""
    from repro_torch.serving.profiling import decode_cost, prefill_cost
    q = torch.zeros((2, 1, 2, 8), dtype=torch.bfloat16)
    case = dict(q=q, lengths=torch.tensor([10, 3]), window=4,
                block_tables=torch.zeros((2, 5), dtype=torch.int32))
    assert decode_cost(case) == (2 * 2 * 2 * 8 * 2 + 7 * 8 * 2 * 2
                                 + 2 * 4 * 6, 4 * 7 * 2 * 8)
    case = dict(q=torch.zeros((1, 1, 3 * 2, 8)), group=2,
                start_pos=torch.tensor([5]), q_lens=torch.tensor([3]),
                window=None, block_tables=torch.zeros((1, 2),
                                                       dtype=torch.int32))
    assert prefill_cost(case) == (2 * 6 * 8 * 4 + 8 * 8 * 4 * 2 + 4 * 4,
                                  4 * (6 + 7 + 8) * 2 * 8)


def test_fault_tolerance_benchmark_on_cpu(tmp_path):
    from repro_torch.benchmarks import fault_tolerance as ft
    out = tmp_path / "BENCH_torch_faults.json"
    rows = ft.main(["--device", "cpu", "--out", str(out),
                    "--trace-out", str(tmp_path / "tf.jsonl")])
    rec = json.loads(out.read_text())
    assert rec["bit_identical_outputs"] is True
    assert rec["requests_completed"] == rec["n_requests"] == 12
    assert rec["failed_requests"] == 0 and rec["failovers"] == 1
    assert rec["salvage_success_rate"] == 1.0
    assert rec["recovery_wall_s"] >= 0 and rec["device"] == "cpu"
    assert rec["health"]["replica1"]["state"] == "dead"
    assert [r[0] for r in rows] == ["fault_tolerance/kill_1_of_3",
                                    "fault_tolerance/recovery"]
    assert _trace_report().main(["--validate", "--faults",
                                 str(tmp_path / "tf.jsonl")]) == 0


def test_fabric_benchmark_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from repro_torch.benchmarks import fabric as fb
    out = tmp_path / "BENCH_torch_fabric.json"
    rows = fb.main(["--device", "cpu", "--out", str(out),
                    "--trace-out", str(tmp_path / "tfa.jsonl")])
    rec = json.loads(out.read_text())
    assert rec["bit_identical_outputs"] is True
    assert rec["requests_completed"] == rec["n_requests"] == 12
    assert rec["failed_requests"] == 0 and rec["failovers"] >= 1
    assert rec["salvage_success_rate"] == 1.0
    assert rec["backend"] == "LocalProcessBackend"
    assert rec["health"][rec["killed_replica"]]["state"] == "dead"
    assert [r[0] for r in rows] == ["fabric/kill_1_of_3_processes",
                                    "fabric/recovery"]
    assert _trace_report().main(["--validate", "--fleet",
                                 str(tmp_path / "tfa.jsonl")]) == 0
    assert fb.model_spec_for("cuda") is None
    assert fb.model_spec_for("cpu")["engine"]["device"] == "cpu"
