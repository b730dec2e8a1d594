"""The run fails without a card rather than falling back to the CPU, and
fails where only the benchmark's own files are present."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import chipbench_cpu as C


def _run(cwd, env_extra=None, seconds="1"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "qwen2-0.5b.train", "--seed", "2147483999", "--seconds", seconds,
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=240)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_no_card_no_result():
    out = _run(C.ROOT)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(C.ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not _has_result(out.stdout)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_a_short_run_on_the_card_prints_one_result(card):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "qwen2-0.5b.train", "--seed", "7", "--seconds", "3", "--trace",
         "0"], cwd=C.ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
