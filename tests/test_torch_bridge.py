"""Weight bridge: the reference's parameter tree <-> the port's tensors.

The reference's ``init_params`` tree is flattened with the checkpoint
module's own path keys, handed to ``repro_torch.bridge`` and back; the
round trip must be exact for every leaf (f32), and the port's own
``init_params`` must produce the same keys, shapes and layout."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

ARCHS = ["qwen2-0.5b", "gemma2-2b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref_flat(request):
    cfg = get_smoke_config(request.param)
    # jitted: the same weights as eager init, compiled once
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return request.param, flat


def test_round_trip_is_exact(ref_flat):
    _, flat = ref_flat
    back = bridge.to_flat(bridge.from_flat(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bf16_weights_keep_norms_f32(ref_flat):
    """Held in bf16, linear/bias/embedding leaves equal the reference's
    per-call cast exactly; norm scales stay f32 and exact."""
    _, flat = ref_flat
    tree = bridge.from_flat(flat, weight_dtype=torch.bfloat16)
    back = bridge.to_flat(tree)
    for k, v in flat.items():
        if k.endswith("/scale"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        else:
            want = np.asarray(jax.numpy.asarray(v, jax.numpy.bfloat16)
                              .astype(jax.numpy.float32))
            np.testing.assert_array_equal(back[k], want, err_msg=k)


def test_port_init_matches_reference_layout(ref_flat):
    arch, flat = ref_flat
    cfg = port_smoke_config(arch)
    ours = bridge.to_flat(PT.init_params(cfg, torch.Generator().manual_seed(0)))
    assert sorted(ours) == sorted(flat)
    for k, v in flat.items():
        assert ours[k].shape == v.shape, (k, ours[k].shape, v.shape)
    # truncated normal at the reference's stddevs: bounded by 2 sigma
    d = cfg.d_model
    w = ours["layers/attn/wq/w"]
    assert np.abs(w).max() <= 2.0 / np.sqrt(d) + 1e-6
    assert 0.5 / np.sqrt(d) < w.std() < 1.0 / np.sqrt(d)
    np.testing.assert_array_equal(ours["final_norm/scale"], 0.0)
