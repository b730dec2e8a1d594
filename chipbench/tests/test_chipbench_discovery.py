"""A new cell, configuration, traffic kind or per-layer metric is found by
its files and BENCHMARK.json entries alone."""
import json
import shutil

from chipbench import core
import chipbench_cpu as C


def _copy(tmp_path):
    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(C.ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(tmp_path / "BENCHMARK.json") as f:
        return json.load(f)


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    bench = _copy(tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "chipbench").rglob("*") if p.is_file()}
    # a configuration, a cell and a per-layer metric, as files + entries
    cfg = json.loads((tmp_path / "chipbench" / "configs"
                      / "qwen2-0.5b.json").read_text())
    (tmp_path / "chipbench" / "configs" / "qwen2-0.5b.copy.json").write_text(
        json.dumps(cfg))
    qwen2 = next(c for c in bench["configs"] if c["name"] == "qwen2-0.5b")
    bench["configs"].append(dict(qwen2, name="qwen2-0.5b.copy",
                                 file="chipbench/configs/qwen2-0.5b.copy.json"))
    spec = json.loads((tmp_path / "chipbench" / "workloads"
                       / "qwen2-0.5b.train.json").read_text())
    spec.update(name="qwen2-0.5b.copy.train8", config="qwen2-0.5b.copy",
                global_batch=8)
    (tmp_path / "chipbench" / "workloads"
     / "qwen2-0.5b.copy.train8.json").write_text(json.dumps(spec))
    bench["workloads"].append({"name": "qwen2-0.5b.copy.train8",
                               "config": "qwen2-0.5b.copy",
                               "traffic": "train8", "chips": 1,
                               "why": "a second batch size"})
    bench["end_to_end"][3]["workloads"].append("qwen2-0.5b.copy.train8")
    (tmp_path / "chipbench" / "layer_metrics" / "steps_in_window.py"
     ).write_text("def read(ctx):\n    return ctx.get('steps')\n")
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = core.benchmark(tmp_path)
    entry, spec2, config = core.resolve(tmp_path, b, "qwen2-0.5b.copy.train8")
    assert spec2["global_batch"] == 8 and config == cfg
    names = [m["name"] for m in core.cell_metrics(
        b, "qwen2-0.5b.copy.train8", True)]
    assert "steps_in_window" in names and "mfu.train" not in names
    assert [m["name"] for m in core.cell_metrics(
        b, "qwen2-0.5b.copy.train8", False)] == ["train_tokens_per_s",
                                                 "setup_s"]
    got = core.read_layer_metrics(
        tmp_path, [m for m in b["per_layer"]
                   if m["name"] == "steps_in_window"], {"steps": 12})
    assert got == {"steps_in_window": {"value": 12.0, "unit": "steps"}}

    res = core.run_cell(tmp_path, "qwen2-0.5b.copy.train8", 5, 0.3, False,
                        device="cpu", overrides=C.train_smoke)
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(res["checks"]) == {"grad_gap", "grad_gap_worst",
                                  "change_gap"}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "chipbench").rglob("*") if p.is_file()
             and "__pycache__" not in str(p)}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in str(k))


def test_a_metric_that_finds_nothing_is_left_out(tmp_path):
    _copy(tmp_path)
    b = core.benchmark(tmp_path)
    ms = core.cell_metrics(b, "qwen2-0.5b.train", True)
    assert core.read_layer_metrics(tmp_path, ms, {"window_s": 1.0}) == {}
