"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and the entry
points that default to the card refuse to run without one."""
import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


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


def test_launcher_rejects_what_later_slices_port():
    from repro_torch.launch import serve
    for argv in (["--replicas", "2", "--paged"], ["--fabric", "mock",
                                                   "--paged"], []):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                        *argv])
