"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B.

48L, d_model=2048, 32H (GQA kv=4, head_dim=128), per-expert d_ff=768,
vocab=151936, MoE 128 experts top-8 (fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151_936,
    num_experts=128, num_experts_per_tok=8,
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=64, vocab_size=307,
    num_experts=4, num_experts_per_tok=2,
    rope_theta=1_000_000.0, tie_embeddings=False,
)
