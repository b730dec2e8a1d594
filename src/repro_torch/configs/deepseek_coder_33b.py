"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L, d_model=7168, 56H (GQA kv=8, head_dim=128), d_ff=19200, vocab=32256.
long_500k runs under the documented sliding-window variant (window 8192).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32_256,
    rope_theta=100_000.0,
    long_context_window=8192, tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=307,
    rope_theta=100_000.0,
    long_context_window=8192, tie_embeddings=False,
)
