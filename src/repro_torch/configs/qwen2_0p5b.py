"""qwen2-0.5b [dense] — arXiv:2407.10671.

24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151936, QKV bias,
tied embeddings.  long_500k runs under the documented sliding-window
variant (window 8192).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151_936,
    qkv_bias=True, rope_theta=1_000_000.0,
    long_context_window=8192, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=307,
    qkv_bias=True, rope_theta=1_000_000.0,
    long_context_window=8192, tie_embeddings=True,
)
