"""gemma2 at its real head dim, 288, against the reference on the CPU.

The gemma2 smoke config has a head dim of 32; gemma2-2b's is 288, the
width the tensor-core flash and prefill kernels take in 32-key tiles.  Here
a 2-layer gemma2 keeps every gemma2 feature (local / global layers, the
window, both softcaps, post-block norms, the scaled and tied embedding) at
d_model 576 over 2 / 1 heads of 288, d_ff 1,024, vocab 512 and window 8,
on weights bridged from the reference's init.  On CPU tensors the port's
kernel wrappers run their plain versions, so this holds the model around
the kernels at D 288; ``chip_smoke.py`` phase 24 holds the kernels there
on the card.

Tolerances are the gemma2 smoke tests' (``test_torch_train.py``): the
loss rtol 1e-3, gradients by each leaf's relative norm error 3e-2 in bf16
and 1e-4 in f32; paged greedy tokens identical at raw argmax (tie eps 0,
as ``test_torch_serving.py`` serves gemma2).  Forward logits: in f32
within 1e-4 (read 2.6e-6: the same algorithm, f32 sums in another order);
in bf16 within the smoke tests' 1e-2 scaled by sqrt(576 / 128), 2.1e-2:
the bf16 roundings of the residual stream, taken at other points by the
jitted reference and the eager port, add up over d_model-long dot
products, so their gap grows with the square root of the width (read
1.06e-2 at most, 7.7e-3 at the 99.9th percentile, over the 24,576
logits; the smoke width reads ~4.5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.data import SyntheticTokenSource as JSource
from repro.data import TokenDatasetSpec as JSpec
from repro.models import transformer as T
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import Scheduler as RefScheduler
from repro.serving import ServingEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.distributed import stepfn as pstep
from repro_torch.models import transformer as PT
from repro_torch.serving import (Request, SamplingParams, Scheduler,
                                 ServingEngine)

torch.set_num_threads(2)

WIDTHS = dict(num_layers=2, d_model=576, num_heads=2, num_kv_heads=1,
              d_ff=1024, vocab_size=512, sliding_window=8)
LOGIT_ATOL = {"bfloat16": 1e-2 * (576 / 128) ** 0.5, "float32": 1e-4}
LOSS_RTOL = 1e-3
GRAD_RTOL = {"bfloat16": 3e-2, "float32": 1e-4}
SEQ, BATCH = 24, 2


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("gemma2-2b").with_(**WIDTHS)
    pcfg = port_smoke_config("gemma2-2b").with_(**WIDTHS)
    assert cfg.resolved_head_dim == pcfg.resolved_head_dim == 288
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    batch = JSource(JSpec(cfg.vocab_size, SEQ, BATCH)).batch(0)
    return cfg, pcfg, params, bridge.from_flat(_flat_np(params)), batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_logits_and_loss_match_reference(model, dtype):
    """SEQ 24 runs past the window of 8 on the local layer."""
    cfg, pcfg, params, pparams, batch = model
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    want, _ = jax.jit(lambda p, b: T.forward(p, cfg, b))(params, _jb(batch))
    want_loss, _ = jax.jit(lambda p, b: T.lm_loss(p, cfg, b))(params,
                                                             _jb(batch))
    with torch.no_grad():
        got, _ = PT.forward(pparams, pcfg, _tb(batch))
        loss, _ = PT.lm_loss(pparams, pcfg, _tb(batch))
    assert got.shape == (BATCH, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL[dtype], rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grads_match_reference(model, dtype):
    cfg, pcfg, params, pparams, batch = model
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b), has_aux=True))(params,
                                                          _jb(batch))
    got, _, pg = pstep.value_and_grad(
        lambda p, b: PT.lm_loss(p, pcfg, b), pparams, _tb(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    jg, pg = _flat_np(jg), bridge.to_flat(pg)
    assert set(jg) == set(pg)
    errs = {k: float(np.linalg.norm(pg[k] - jg[k]) / np.linalg.norm(jg[k]))
            for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL[dtype], (worst, errs[worst])


def _serve(engine_cls, sched_cls, req_cls, sp_cls, cfg, params, prompts,
           max_new, engine_kw):
    eng = engine_cls(cfg, params, **engine_kw)
    sched = sched_cls(eng, prefill_token_budget=16)
    rids = [sched.submit(req_cls(p, sp_cls(max_new_tokens=m, greedy=True)))
            for p, m in zip(prompts, max_new)]
    sched.run()
    return [sched.output(r).tolist() for r in rids], sched


def test_paged_greedy_tokens_match_reference(model):
    """Prompts of 14-33 tokens on a 20-token shared prefix run past the
    window; 4-row co-prefill, budgeted rounds, the prefix cache on."""
    cfg, pcfg, params, pparams, _ = model
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n,
                                                    dtype=np.int32)])
               for n in (3, 13, 1, 9)]
    max_new = (6, 4, 7, 5)
    engine_kw = dict(max_seq_len=48, max_slots=3, kv_block_size=8,
                     paged=True, greedy_tie_eps=0.0, prefix_cache_blocks=16,
                     prefill_batch=4)
    ref, ref_sched = _serve(RefEngine, RefScheduler, RefRequest,
                            RefSamplingParams, cfg, params, prompts, max_new,
                            engine_kw)
    ours, sched = _serve(ServingEngine, Scheduler,
                         Request, SamplingParams, pcfg, pparams, prompts,
                         max_new, dict(engine_kw, device="cpu"))
    assert ours == ref
    assert [len(o) for o in ours] == list(max_new)
    assert sched.engine.prefill_tokens == ref_sched.engine.prefill_tokens
    assert sched.metrics.prefix_hits > 0
    kv = sched.engine.kv
    assert kv.free_slot_count == kv.max_slots and kv.pool.in_use == 0
