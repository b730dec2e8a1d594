"""whisper-small [audio enc-dec] — arXiv:2212.04356.

12L decoder / 12L encoder, d_model=768, 12H (kv=12: MHA), d_ff=3072,
vocab=51865.  The conv/mel frontend is a stub, as in the reference:
``input_specs`` provides (B, 1500, 768) frame embeddings.  LayerNorm, GELU
and learned position embeddings; ``max_pos_embed`` is the reference's
32,768 (its decode_32k shape), though whisper's own decoder context is
448 positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500,
    norm_type="layernorm", act="gelu", qkv_bias=True,
    max_pos_embed=32_768, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=211,
    encoder_layers=2, encoder_seq=32,
    norm_type="layernorm", act="gelu", qkv_bias=True,
    max_pos_embed=128, tie_embeddings=True,
)
