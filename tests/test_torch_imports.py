"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and the entry
points that default to the card refuse to run without one."""
import ast
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20, files
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/core/registry.py",
            "src/repro_torch/core/container.py",
            "src/repro_torch/core/deploy.py",
            "src/repro_torch/launch/slurm.py",
            "src/repro_torch/benchmarks/container_overhead.py",
            "src/repro_torch/benchmarks/allreduce_vs_ps.py",
            "src/repro_torch/benchmarks/scaling.py",
            "src/repro_torch/serving/faults.py",
            "src/repro_torch/serving/health.py",
            "src/repro_torch/serving/gateway.py",
            "src/repro_torch/serving/fabric/mailbox.py",
            "src/repro_torch/serving/fabric/registry.py",
            "src/repro_torch/serving/fabric/worker.py",
            "src/repro_torch/serving/fabric/backends.py",
            "src/repro_torch/serving/fabric/remote.py",
            "src/repro_torch/benchmarks/fault_tolerance.py",
            "src/repro_torch/benchmarks/fabric.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/qwen3_moe_30b_a3b.py",
            "src/repro_torch/configs/dbrx_132b.py",
            "src/repro_torch/configs/gemma2_27b.py",
            "src/repro_torch/configs/deepseek_coder_33b.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/stepfn.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/dryrun.py",
            "examples/torch_quickstart.py",
            "examples/torch_deploy_supermuc.py",
            "examples/torch_train_lm.py",
            "examples/torch_serve_lm.py",
            "examples/torch_train_3dgan.py"} <= names
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.serving import slo\n"
                     "import jax.numpy as jnp\n")
    assert [m for _, m in _imported_roots(probe)
            if m in FORBIDDEN] == ["repro", "jax"]


def _load_example(name):
    """``examples/<name>.py`` through ``chip_smoke.load_example``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import load_example
    return load_example(name)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is for "
                    "machines without one")


def test_engine_defaults_to_cuda_and_refuses_without_a_card():
    _no_card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, max_seq_len=32, max_slots=2,
                      kv_block_size=8)


def test_launcher_defaults_to_cuda_and_refuses_without_a_card():
    _no_card()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--paged",
                    "--requests", "1"])


def test_fabric_worker_engine_defaults_to_cuda_and_refuses_without_a_card():
    """``build_engine`` takes its device from the model spec's engine
    kwargs, by default the engine's: the card."""
    _no_card()
    from repro_torch.serving.fabric import DEFAULT_MODEL_SPEC, build_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine({"engine": dict(DEFAULT_MODEL_SPEC["engine"],
                                     device="cuda")})
    eng = build_engine({"engine": dict(DEFAULT_MODEL_SPEC["engine"],
                                       device="cpu")})
    assert eng.device.type == "cpu" and eng.max_slots == 3


@pytest.mark.parametrize("bench", ["fault_tolerance", "fabric"])
def test_fleet_benchmarks_default_to_cuda_and_refuse_without_a_card(
        bench, tmp_path):
    _no_card()
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{bench}")
    out = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(out), "--trace-out",
                  str(tmp_path / "t.jsonl")])
    assert not out.exists()


def test_train_3dgan_defaults_to_cuda_and_refuses_without_a_card():
    _no_card()
    from repro_torch.launch import train_3dgan
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_3dgan.main(["--smoke", "--steps", "1"])


def test_launcher_rejects_what_later_slices_port(tmp_path):
    """Since the fleet slice the launcher serves ``--replicas N`` and
    ``--fabric`` through the gateway; what it still refuses is what the
    reference's refuses: ``--fabric`` without ``--smoke``, and ``--fabric``
    with ``--profile`` or ``--slo-config``.  Without ``--paged`` it serves
    in dense mode, as the reference's does."""
    from repro_torch.launch import serve
    slo = tmp_path / "slo.json"
    slo.write_text('{"default": {"ttft_p95_ms": 1000.0}}')
    for argv in (["--fabric", "mock"],
                 ["--fabric", "mock", "--smoke", "--profile"],
                 ["--fabric", "local", "--smoke", "--slo-config", str(slo)]):
        with pytest.raises(SystemExit, match="--fabric"):
            serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", *argv])
    gw = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--max-new", "2", "--greedy",
                     "--max-seq-len", "32"])
    sched = gw.replicas[0].scheduler
    assert len(gw.replicas) == 1 and not sched.engine.paged
    assert sched.metrics.summary()["requests_completed"] == 2


@pytest.mark.parametrize("entry", ["quickstart", "deploy_supermuc",
                                   "container_overhead", "allreduce_vs_ps",
                                   "scaling"])
def test_deployment_entry_points_default_to_cuda_and_refuse_without_a_card(
        entry, tmp_path):
    _no_card()
    import importlib
    out = ["--out", str(tmp_path / "bench.json")]
    if entry == "container_overhead":
        from repro_torch.benchmarks import container_overhead as mod
        argv = out + ["--smoke"]
    elif entry in ("allreduce_vs_ps", "scaling"):
        mod = importlib.import_module(f"repro_torch.benchmarks.{entry}")
        argv = out + ["--ranks", "2"]
    else:
        mod = _load_example(f"torch_{entry}")
        argv = ["--smoke"] if entry == "quickstart" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "bench.json").exists()


@pytest.mark.parametrize("entry", ["train_lm", "serve_lm", "train_3dgan"])
def test_examples_default_to_cuda_and_refuse_without_a_card(entry, tmp_path):
    _no_card()
    mod = _load_example(f"torch_{entry}")
    argv = (["--ckpt-dir", str(tmp_path / "ckpt")] if entry == "train_lm"
            else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "ckpt").exists()


def test_nccl_ranks_need_a_card_each(monkeypatch, tmp_path):
    """``hvd.run_ranks`` on ``cuda`` refuses more ranks than cards before
    it starts any, with a typed error."""
    from repro_torch.core import hvd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(hvd.DeviceCountError, match="2 NCCL ranks need 2"):
        hvd.run_ranks("raise SystemExit(1)", 2, tmp_path, device="cuda")
    assert not (tmp_path / "store").exists()
