"""gemma2-27b [dense] — arXiv:2408.00118.

46L, d_model=4608, 32H (GQA kv=16), d_ff=36864, vocab=256000.
Local(4096-window)/global alternating attention, attn-logit softcap 50,
final-logit softcap 30, post-block norms, scaled embeddings, GELU.
head_dim = d_model/heads = 144 per the assigned table (DESIGN.md §9).
long_500k qualifies natively via the local/global pattern.
"""
from repro_torch.configs.base import ModelConfig

_COMMON = dict(
    family="dense", local_global_pattern=True, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, embed_scale=True, act="gelu",
    tie_embeddings=True,
)

CONFIG = ModelConfig(
    name="gemma2-27b", num_layers=46, d_model=4608, num_heads=32,
    num_kv_heads=16, d_ff=36864, vocab_size=256_000, **_COMMON)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-27b-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=307,
    **{**_COMMON, "sliding_window": 8})
