"""The yardstick's arithmetic against counts worked out by hand."""
import json

import pytest

from chipbench import costs, stats
import chipbench_cpu as C


# qwen3-moe-30b-a3b's published sizes (hf:Qwen/Qwen3-30B-A3B config.json)
QWEN3_MOE = {"hidden_size": 2048, "num_hidden_layers": 48,
             "num_attention_heads": 32, "num_key_value_heads": 4,
             "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
             "moe_intermediate_size": 768, "vocab_size": 151936}


def _config(name):
    with open(C.ROOT / "chipbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_decode_cost_by_hand():
    # B 2, KV 1, G 2, D 4; rows of 3 and 5 positions; 2 table entries
    nbytes, flops = costs.decode_cost((2, 1, 2, 4), 2, [3, 5])
    q_bytes = 2 * 1 * 2 * 4 * 2
    assert nbytes == 2 * q_bytes + 8 * 1 * 4 * 2 * 2 + 2 * 4 * 3
    assert flops == 4 * 8 * 1 * 2 * 4


def test_decode_cost_is_the_ports_count():
    from repro_torch.kernels import paged_attention as pa
    for shape, pps, lengths in [((64, 4, 8, 128), 64, [1] * 20 + [700] * 44),
                                ((3, 2, 7, 64), 5, [1, 33, 80])]:
        assert costs.decode_cost(shape, pps, lengths) == pa.cost(
            shape, pps, lengths=lengths)


def test_flash_cost_is_the_ports_count():
    from repro_torch.kernels import flash_attention as fa
    assert costs.flash_fwd_cost(16, 1024, 1024, 14, 2, 64) == fa.cost(
        16, 1024, 1024, 14, 2, 64)
    assert costs.causal_pairs(4, 4) == 10


def test_qwen2_flops_by_hand():
    f = costs.ModelFlops(_config("qwen2-0.5b"))
    per_layer = (896 * 896 + 2 * 896 * 128 + 896 * 896
                 + 3 * 896 * 4864)
    assert f.matmul_params == per_layer == 14_909_440
    assert f.matmul_params * 24 + f.unembed_params == 493_961_216
    attn = 3 * 4 * 14 * 64 * (1024 + 1) / 2 * 24
    assert f.train_step(16, 1024) == pytest.approx(
        (6 * 493_961_216 + attn) * 16 * 1024)


def test_moe_flops_count_the_routed_experts_only():
    f = costs.ModelFlops(QWEN3_MOE)
    attn = 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
    routed = 2048 * 128 + 8 * 3 * 2048 * 768
    assert f.matmul_params == attn + routed
    all_experts = 2048 * 128 + 128 * 3 * 2048 * 768
    assert f.matmul_params < attn + all_experts / 10


def test_prompt_flops_count_real_tokens_and_one_output_projection():
    f = costs.ModelFlops(QWEN3_MOE)
    n = 100
    want = (2 * f.matmul_params * 48 * n + 2 * f.unembed_params
            + 4 * 32 * 128 * 48 * n * (n + 1) / 2)
    assert f.prompt_tokens_fwd(n, (n + 1) / 2) + 2 * f.unembed_params \
        == pytest.approx(want)
    assert f.token_fwd(99) == pytest.approx(
        2 * f.matmul_params * 48 + 2 * f.unembed_params
        + 4 * 32 * 128 * 48 * 100)


def test_percentiles_and_rates_by_hand():
    xs = list(range(1, 11))
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.beyond(xs, 90) == 1
    assert stats.rate(510, 51.0) == 10.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_bound_is_the_larger_of_the_two_terms():
    assert costs.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 989e12) == pytest.approx(1.0)
