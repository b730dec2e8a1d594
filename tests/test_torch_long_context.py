"""The long-context variant (the ``long_500k`` shape's windows) against the
reference: ``layer_pattern(cfg, long_context)`` for every config, and with
``long_context_window`` cut to 4 on the qwen2 (dense) and zamba2 (hybrid:
the shared block takes the window) smoke configs, ``forward`` and eight
``decode_step``s on the reference's bridged weights.

Tolerances: the smoke tolerances of ``tests/test_torch_model.py`` and
``tests/test_torch_ssm_serving.py`` (bf16 logits within atol 1e-2 of the
jitted reference's).  The window must matter: the logits with and without
``long_context`` differ by more than that tolerance once a sequence is
past the window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

LOGIT_ATOL = 1e-2
WINDOW = 4
B, S = 2, 12


def test_layer_pattern_matches_reference_for_every_config():
    from repro.configs import ARCHS, get_config, get_smoke_config
    from repro.models.transformer import layer_pattern as ref_pattern
    from repro_torch import configs as pc
    from repro_torch.models.transformer import layer_pattern
    for arch in ARCHS:
        for ref_get, port_get in ((get_config, pc.get_config),
                                  (get_smoke_config, pc.get_smoke_config)):
            for lc in (False, True):
                assert layer_pattern(port_get(arch), lc) == ref_pattern(
                    ref_get(arch), lc), (arch, lc)


def test_gemma2_pattern_is_unchanged_by_long_context():
    """gemma2's ``long_context_window`` is None: its (local, global)
    pattern stays (4096, None) in both packages."""
    from repro.configs import get_config
    from repro.models.transformer import layer_pattern as ref_pattern
    from repro_torch import configs as pc
    from repro_torch.models.transformer import layer_pattern
    for arch in ("gemma2-2b", "gemma2-27b"):
        cfg = pc.get_config(arch)
        assert cfg.long_context_window is None
        assert layer_pattern(cfg, True) == layer_pattern(cfg, False) \
            == (4096, None) == ref_pattern(get_config(arch), True)


@pytest.fixture(scope="module", params=["qwen2-0.5b", "zamba2-1.2b"])
def model(request):
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs import get_smoke_config
    from repro.models import transformer as T
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config as port_smoke
    cfg = get_smoke_config(request.param).with_(long_context_window=WINDOW)
    pcfg = port_smoke(request.param).with_(long_context_window=WINDOW)
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    return cfg, pcfg, params, bridge.from_flat(flat), toks


def test_forward_long_context_matches_reference(model):
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, toks = model
    fwd = jax.jit(T.forward, static_argnums=1,
                  static_argnames=("long_context",))
    got = {}
    for lc in (False, True):
        want, _ = fwd(params, cfg, {"tokens": jnp.asarray(toks)},
                      long_context=lc)
        got[lc], _ = PT.forward(pparams, pcfg,
                                {"tokens": torch.from_numpy(toks)},
                                long_context=lc)
        np.testing.assert_allclose(got[lc].detach().numpy(),
                                   np.asarray(want), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"long_context={lc}")
    # the window changes the positions past it, not the ones within it
    diff = (got[True] - got[False]).abs().detach()
    assert diff[:, :WINDOW].max() == 0
    assert diff[:, WINDOW:].max() > 10 * LOGIT_ATOL


def test_decode_long_context_matches_reference(model):
    from repro.models import transformer as T
    from repro_torch.models import transformer as PT
    cfg, pcfg, params, pparams, toks = model
    step = jax.jit(T.decode_step, static_argnums=1,
                   static_argnames=("long_context",))
    logits = {}
    for lc in (False, True):
        jc, tc = T.init_cache(cfg, B, S), PT.init_cache(pcfg, B, S)
        worst, logits[lc] = 0.0, []
        for t in range(S):
            pos = np.full((B,), t, np.int32)
            jl, jc = step(params, cfg, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "positions": jnp.asarray(pos),
                                        "cache": jc}, long_context=lc)
            tl, tc = PT.decode_step(pparams, pcfg, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "positions": torch.from_numpy(pos), "cache": tc},
                long_context=lc)
            worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl))
                                     .max()))
            logits[lc].append(tl)
        assert worst <= LOGIT_ATOL, (lc, worst)
    late = max(float((a - b).abs().max()) for a, b in
               zip(logits[True][WINDOW:], logits[False][WINDOW:]))
    assert late > 10 * LOGIT_ATOL
    assert all(torch.equal(a, b) for a, b in
               zip(logits[True][:WINDOW], logits[False][:WINDOW]))
