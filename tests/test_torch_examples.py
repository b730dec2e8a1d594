"""The port's counterparts of the reference's examples on the CPU:
``examples/torch_train_lm.py``, ``torch_serve_lm.py`` and
``torch_train_3dgan.py``, each with its reference's flags plus
``--device``, printing its reference's markers (``tests/test_examples.py``
runs ``train_lm.py --model tiny --steps 25`` and looks for "DOWN").

The LM example once as a script (the reference test's run) and in
process at the smoke size through a checkpoint and a resume: the resumed
run's steps equal the uninterrupted run's bit for bit (the CPU's steps
are deterministic).  The serving example's burst and chat modes (paged
KV, the prefix cache serving each turn's history).  The 3DGAN example
inside its capsule equal to the bare launcher bit for bit, and at gloo
world size 2 (``hvd.run_ranks``; each rank deploys its own image): the
ranks agree and hand the data group world size 1's exchange a step."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hvd

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


sys.path.insert(0, str(ROOT))
from chip_smoke import load_example as _example  # noqa: E402


def test_torch_train_lm_example_short():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
         "--model", "tiny", "--steps", "25", "--seq-len", "64", "--batch",
         "8", "--ckpt-every", "0", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "(DOWN)" in r.stdout and "tok/s" in r.stdout


def test_torch_train_lm_checkpoints_and_resumes(tmp_path, capsys):
    mod = _example("torch_train_lm")
    argv = ["--model", "smoke", "--steps", "6", "--seq-len", "32",
            "--batch", "4", "--device", "cpu"]
    first = mod.main(argv + ["--ckpt-every", "3", "--ckpt-dir",
                             str(tmp_path / "a")])
    assert [Path(p).name for p in first["checkpoints"]] == [
        "step_000000003", "step_000000006"]
    # resume from step 3 (the newest checkpoint in a directory of its own)
    shutil.copytree(tmp_path / "a" / "step_000000003",
                    tmp_path / "b" / "step_000000003")
    second = mod.main(argv + ["--resume", "--ckpt-every", "0",
                              "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and out.count("(DOWN)") == 2
    assert second["start"] == 3 and second["end"] == 9
    assert second["losses"][:3] == first["losses"][3:]


def test_torch_serve_lm_burst_example(capsys):
    res = _example("torch_serve_lm").main(["--device", "cpu", "--max-new",
                                           "6"])
    out = capsys.readouterr().out
    assert res["paged"] and "paged KV" in out
    assert "batch=4 requests" in out and "tok/s batched decode" in out
    assert [len(o) for o in res["outputs"]] == [6] * 4


def test_torch_serve_lm_chat_example(capsys):
    res = _example("torch_serve_lm").main(["--chat", "--turns", "3",
                                           "--max-new", "8", "--device",
                                           "cpu"])
    out = capsys.readouterr().out
    assert "prefix cache on" in out and "prefix cache: hit rate" in out
    turns = res["turns"]
    assert turns[0]["recomputed"] == turns[0]["prompt"]
    # later turns replay the history from the prefix store: only the tail
    # past its last whole block is recomputed
    for t in turns[1:]:
        assert 0 < t["recomputed"] < t["prompt"] - 64
    assert res["prefix_cache"]["hit_rate"] > 0.5


def test_torch_train_3dgan_example_in_its_capsule_equals_bare(capsys):
    from repro_torch.launch import train_3dgan
    argv = ["--device", "cpu", "--steps", "2", "--batch", "4"]
    inside = _example("torch_train_3dgan").main(argv)
    out = capsys.readouterr().out
    assert "ch-build: 3dgan" in out and "capsule run complete" in out
    assert "img/s" in out and "corr(requested E, generated deposition)" in out
    bare = train_3dgan.main(argv)
    assert inside["image"] == "3dgan" and inside["world_size"] == 1
    assert inside["d_losses"] == bare["d_losses"]
    assert inside["g_losses"] == bare["g_losses"]


RANK = """
import importlib.util, json, os, sys
import torch
torch.set_num_threads(1)
store, out = sys.argv[1], sys.argv[2]
spec = importlib.util.spec_from_file_location("ex", sys.argv[3])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
from repro_torch.core import hvd
# the group on the run's file:// store, which the launcher's hvd.init
# inside the capsule then joins
with hvd.init("cpu", init_method=store):
    res = mod.main(["--device", "cpu", "--steps", "2", "--batch", "4"])
json.dump({k: res[k] for k in ("world_size", "d_losses", "g_losses",
                               "collectives_per_step", "image")},
          open(os.path.join(out, f"rank{os.environ['RANK']}.json"), "w"))
"""


def test_torch_train_3dgan_example_at_gloo_world_size_2(tmp_path):
    """One global batch of 4 over 2 gloo ranks, each inside its capsule
    (each rank draws its own shard's events): both ranks report the same
    all_reduced losses, finite, and hand the data group the same
    exchange a step as one rank does (the gradients of both models and
    the metrics, whatever the world size)."""
    runs = {}
    for w in (1, 2):
        d = tmp_path / f"w{w}"
        d.mkdir()
        hvd.run_ranks(RANK, w, d, str(ROOT / "examples"
                                      / "torch_train_3dgan.py"), timeout=300)
        runs[w] = [json.loads((d / f"rank{r}.json").read_text())
                   for r in range(w)]
    one, (r0, r1) = runs[1][0], runs[2]
    assert r0["world_size"] == r1["world_size"] == 2 and r0["image"] == "3dgan"
    for k in ("d_losses", "g_losses"):
        assert r0[k] == r1[k] and np.isfinite(r0[k]).all(), k
    assert r0["collectives_per_step"] == r1["collectives_per_step"] \
        == one["collectives_per_step"]
