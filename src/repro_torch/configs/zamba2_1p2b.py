"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38L Mamba2 backbone, d_model=2048, ssm_state=64; one weight-SHARED
attention+MLP block (32H, kv=32 MHA, d_ff=8192) applied every 6 mamba
layers (6 groups of 6 + 2 tail mamba layers).  ``long_context_window``
is the reference's number: the shared block's window under the
long-context variant (the ``long_500k`` shape).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, hybrid_attn_every=6,
    long_context_window=8192, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=211,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, hybrid_attn_every=2,
    long_context_window=8192, tie_embeddings=True,
)
