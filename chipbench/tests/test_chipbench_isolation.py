"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import subprocess
import sys

import chipbench_cpu as C

PKG = C.ROOT / "chipbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "numpy", "torch",
               "chipbench"}
    for path in (PKG / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in allowed, (path, name)
            if name.startswith("chipbench"):
                assert name.startswith("chipbench.reference"), (path, name)


def test_a_fresh_process_running_both_cells_loads_no_jax():
    prog = f"""
import sys
sys.path[:0] = [{str(C.ROOT)!r}, {str(C.ROOT / 'src')!r},
                {str(PKG / 'tests')!r}]
import chipbench_cpu as C
from chipbench import core
C.run_smoke("qwen2-0.5b.train", seconds=0.2)
C.run_smoke("qwen2-0.5b.clients64", seconds=3.0)
print(core.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=240, cwd=C.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_the_check_compares_whole_top_level_names():
    from chipbench import core
    assert core.forbidden(["jaxlib.xla_client", "numpy", "repro_torch.x",
                           "repro.models", "flax"]) == ["flax", "jaxlib",
                                                        "repro"]
    assert core.forbidden(["repro_torch", "jaxtyping", "chipbench"]) == []
