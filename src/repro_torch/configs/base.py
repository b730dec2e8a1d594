"""Model configuration: a plain-data copy of ``repro.configs.base.ModelConfig``.

The numbers and defaults are the reference's, field for field, so a config
resolves to the same shapes in both packages (gemma2-2b's head_dim, for
example, resolves to 2304 / 8 = 288 here as in the reference).  The
reference's dry-run helpers (``input_specs``, ``synthesize_inputs``) build
JAX shape structs and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // num_heads

    # --- attention features ------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False               # qwen2-vl multimodal RoPE (3 sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w splits of head_dim/2
    attn_logit_softcap: Optional[float] = None       # gemma2: 50.0
    final_logit_softcap: Optional[float] = None      # gemma2: 30.0
    sliding_window: Optional[int] = None             # local-attention window
    local_global_pattern: bool = False               # gemma2 alternating local/global
    # sliding-window variant used only for the long_500k shape on dense archs
    # (documented beyond-paper variant; gemma2 has local layers natively).
    long_context_window: Optional[int] = None
    attn_scale: Optional[float] = None               # default 1/sqrt(head_dim)

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # dispatch-group size: tokens are routed in contiguous groups of this
    # many tokens (shard-aligned).  §Perf lever: per-sequence groups are
    # pathological for decode (1-token groups pad capacity 128x).
    moe_group_size: int = 4096
    # mesh axis to pin the (G, E, C, d) dispatch buffer's expert dim to
    # (expert parallelism via explicit constraint).  §Perf lever: without
    # it XLA materializes an E-full buffer and all-reduces its gradient
    # over the model axis every layer.
    moe_buffer_shard: Optional[str] = None

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256              # SSD chunk length
    ssm_groups: int = 1               # B/C groups (a la GQA for SSM)

    # --- hybrid (zamba2): shared attention block every N mamba layers --------
    hybrid_attn_every: int = 6

    # --- encoder-decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper: 30s audio -> 1500 frames (stub)

    # --- VLM (qwen2-vl): stub patch embeddings prepended ---------------------
    num_patches: int = 0

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-6
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm (whisper)
    act: str = "silu"                 # silu | gelu
    max_pos_embed: int = 0            # >0: learned position embeddings (whisper)
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma2 scales embeddings by sqrt(d_model)
    post_block_norm: bool = False     # gemma2 post-attn/post-ffn norms
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # "nothing" = recompute everything in backward (min memory);
    # "dots" = save matmul outputs (no recompute of the big einsums —
    # trades HBM for the remat FLOPs, a §Perf lever for compute-bound pairs)
    remat_policy: str = "nothing"
    # scan_layers=False unrolls the layer loop (python loop over stacked
    # params) and attn_q_chunk=0 disables query chunking: used by the
    # roofline pass, because XLA cost_analysis counts a while-loop body
    # ONCE rather than x trip-count (see launch/dryrun.py).
    scan_layers: bool = True
    attn_q_chunk: int = 512
    # KV-cache storage: "bfloat16" (default) or "int8" (per-token/head
    # absmax quantization — §Perf lever: halves the decode memory term,
    # which dominates every decode pair in the roofline table)
    kv_cache_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (analytic; used for roofline MODEL_FLOPS = 6·N·D).
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv = self.d_model, self.num_heads, self.num_kv_heads
        dh = self.resolved_head_dim if h else 0
        n = 0
        embed = self.vocab_size * d
        n += embed
        if not self.tie_embeddings:
            n += embed

        def attn_params() -> int:
            p = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
            if self.qkv_bias:
                p += (h + 2 * kv) * dh
            return p

        def mlp_params(dff: int) -> int:
            return 3 * d * dff          # gated (wi, wg, wo)

        for layer in range(self.num_layers):
            if self.family in ("dense", "vlm", "encdec"):
                n += attn_params() + mlp_params(self.d_ff) + 2 * d
            elif self.family == "moe":
                e = self.num_experts_per_tok if active_only else self.num_experts
                n += attn_params() + e * mlp_params(self.d_ff) + d * self.num_experts + 2 * d
            elif self.family == "ssm":
                di, ns = self.ssm_d_inner, self.ssm_state
                g = self.ssm_groups
                in_proj = d * (2 * di + 2 * g * ns + self.ssm_num_heads)
                conv = self.ssm_conv_width * (di + 2 * g * ns)
                out = di * d
                n += in_proj + conv + out + di + 2 * self.ssm_num_heads + d
            elif self.family == "hybrid":
                di, ns = self.ssm_d_inner, self.ssm_state
                g = self.ssm_groups
                in_proj = d * (2 * di + 2 * g * ns + self.ssm_num_heads)
                conv = self.ssm_conv_width * (di + 2 * g * ns)
                n += in_proj + conv + di * d + di + 2 * self.ssm_num_heads + d
        if self.family == "hybrid":
            # one weight-shared attention+MLP block (counted once)
            n += attn_params() + mlp_params(self.d_ff) + 2 * d
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                n += attn_params() + mlp_params(self.d_ff) + 2 * d
            # decoder cross-attention
            n += self.num_layers * attn_params()
        return n
