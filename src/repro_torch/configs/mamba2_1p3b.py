"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, state-space duality).

48L, d_model=2048, attention-free, vocab=50280, ssm_state=128,
head_dim=64 (=> 64 SSD heads at expand=2), conv width 4, chunk 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=211,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
    tie_embeddings=True,
)
