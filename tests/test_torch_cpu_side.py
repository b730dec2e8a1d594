"""``chip_smoke.CpuSide``: the CPU halves of the card-against-CPU checks in
one spawned process.  On the CPU here both halves run on the CPU: a job's
result must equal the same call made in this process, its check must run
when it is collected, a job that raises must fail the run, and ``fetch``
must hand back a queued job's result."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


@pytest.fixture()
def side():
    s = cs.CpuSide(threads=2)
    cs.CPU_SIDE = s
    try:
        yield s
    finally:
        cs.CPU_SIDE = None
        if s.proc.is_alive():
            s.proc.terminate()
            s.proc.join(30)


def test_a_job_on_shared_weights_equals_the_same_call_here(side):
    cfg = get_smoke_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           weight_dtype=torch.float32)
    host = cs.shared_cpu(torch, params)
    assert all(t.is_shared() for t in host.values()
               if isinstance(t, torch.Tensor))
    want = cs.train_step_metrics(torch, "cpu", cfg, params, 16, 2)
    seen = []

    def finish(res):
        seen.append(res)
        return {"loss": res[0]}
    side.submit("train", "train_step_metrics", finish, cfg=cfg, params=host,
                seq=16, batch=2)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 12,
                                               dtype=np.int32)
    kw = dict(paged=True, prefill_batch=1)
    lg, tg, _ = cs.engine_greedy(torch, "cpu", cfg, params, prompt, new=4,
                                 generate=True, engine_kw=kw)
    side.submit("paged", "engine_greedy", cs.engine_pair(
        "paged", lg, tg, (cfg.vocab_size,)), cfg=cfg,
        params=cs.shared_cpu(torch, params), prompt=prompt, new=4,
        generate=True, engine_kw=kw)
    side.close()
    assert side.proc.exitcode == 0
    np.testing.assert_allclose(seen[0], want, rtol=1e-5)
    assert side.report["train"]["loss"] == seen[0][0]
    assert side.report["paged"]["tokens_cpu"] == tg
    assert side.report["paged"]["logit_diff"] <= cs.CPU_LOGIT_TOL


def test_fetch_hands_back_a_queued_result(side):
    cfg = get_smoke_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    prompt = np.arange(1, 9, dtype=np.int32)
    kw = dict(paged=False)
    side.prefetch("dense", "engine_greedy", cfg=cfg,
                  params=cs.shared_cpu(torch, params), prompt=prompt, new=3,
                  generate=False, engine_kw=kw)
    last, toks, other = side.fetch("dense")
    lg, tg, _ = cs.engine_greedy(torch, "cpu", cfg, params, prompt, new=3,
                                 generate=False, engine_kw=kw)
    assert other is None and toks == tg and last.shape == (cfg.vocab_size,)
    np.testing.assert_allclose(last, lg, atol=1e-5)
    side.close()


def test_a_job_that_raises_fails_the_run(side):
    cfg = get_smoke_config("qwen2-0.5b")
    side.submit("broken", "engine_greedy", lambda res: None, cfg=cfg,
                params={}, prompt=np.arange(4, dtype=np.int32), new=1,
                generate=True, engine_kw={})
    with pytest.raises(cs.SmokeFailure, match="broken: the CPU half raised"):
        side.close()
    # a phase boundary checks what is done as well
    side.submit("broken again", "engine_greedy", lambda res: None, cfg=cfg,
                params={}, prompt=np.arange(4, dtype=np.int32), new=1,
                generate=True, engine_kw={})
    deadline = time.monotonic() + 120
    with pytest.raises(cs.SmokeFailure, match="broken again"):
        while time.monotonic() < deadline:
            cs.phase("next")
            time.sleep(0.5)
