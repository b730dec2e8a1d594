"""qwen2-vl-72b [vlm] — arXiv:2409.12191.

80L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=29568, vocab=152064.
M-RoPE (temporal/height/width sections 16/24/24 of head_dim/2=64); the
ViT/projector frontend is a stub, as in the reference: ``input_specs``
provides (B, 256, 8192) patch embeddings, prepended to the text.
``long_context_window`` is the reference's number, read by the
long-context variant (``transformer.layer_pattern(cfg, long_context=True)``,
the ``long_500k`` shape).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=29568, vocab_size=152_064,
    mrope=True, mrope_sections=(16, 24, 24), num_patches=256,
    qkv_bias=True, rope_theta=1_000_000.0,
    long_context_window=8192, tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=307,
    mrope=True, mrope_sections=(8, 4, 4), num_patches=8,
    qkv_bias=True, rope_theta=1_000_000.0,
    long_context_window=8192, tie_embeddings=False,
)
