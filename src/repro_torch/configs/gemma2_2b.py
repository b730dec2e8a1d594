"""gemma2-2b [dense] — arXiv:2408.00118.

26L, d_model=2304, 8H (GQA kv=4), d_ff=9216, vocab=256000.
Same gemma2 features as the 27b: local/global alternation, softcaps,
post-block norms, scaled embeddings.
"""
from repro_torch.configs.base import ModelConfig

_COMMON = dict(
    family="dense", local_global_pattern=True, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, embed_scale=True, act="gelu",
    tie_embeddings=True,
)

CONFIG = ModelConfig(
    name="gemma2-2b", num_layers=26, d_model=2304, num_heads=8,
    num_kv_heads=4, d_ff=9216, vocab_size=256_000, **_COMMON)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-2b-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=512, vocab_size=307,
    **{**_COMMON, "sliding_window": 8})
