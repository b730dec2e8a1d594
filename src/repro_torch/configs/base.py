"""Model configuration: a plain-data copy of ``repro.configs.base.ModelConfig``.

The numbers and defaults are the reference's, field for field, so a config
resolves to the same shapes in both packages (gemma2-2b's head_dim, for
example, resolves to 2304 / 8 = 288 here as in the reference).
``InputShape``, ``SHAPES``, ``shape_skips``, ``input_specs`` and
``synthesize_inputs`` are the reference's definition of a batch: the same
four input shapes, the same skipped pairs, the same keys, shapes, dtypes
and integer ranges, as ``(shape, dtype)`` pairs and tensors instead of JAX
shape structs and arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


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


# ---------------------------------------------------------------------------
# Input shapes and the batch they define
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def shape_skips(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """The reason ``(cfg, shape)`` is skipped, or None (the reference's
    rule: ``long_500k`` is not run for the encdec family, nor for a dense
    or vlm model with no window of any kind)."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return ("enc-dec audio model: 500k-token decode has no audio "
                    "analogue and decoder is pure full attention (see "
                    "DESIGN.md)")
        if cfg.family in ("dense", "vlm") and not (
                cfg.local_global_pattern or cfg.sliding_window
                or cfg.long_context_window):
            return "pure full-attention arch without a sliding-window variant"
    return None


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The reference's ``input_specs`` as nested ``(shape, dtype)`` pairs.

    train/prefill: the batch of tokens (+ the stub frontend's embeddings:
    frames (B, encoder_seq, d) for encdec; for vlm, patch embeddings (B,
    num_patches, d), text tokens (B, S - num_patches) and M-RoPE positions
    (3, B, S)), and labels (B, S) to train.  decode: one new token per
    sequence, its positions (B,) and the decode cache of ``seq_len``
    (``transformer._cache_struct``), plus the encoder output (encdec) or
    (3, B, 1) M-RoPE positions (cfg.mrope)."""
    from repro_torch.models import transformer as T   # imports this module

    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    i32, bf16 = torch.int32, torch.bfloat16
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            specs["encoder_input"] = ((B, cfg.encoder_seq, d), bf16)
            specs["tokens"] = ((B, S), i32)
        elif cfg.family == "vlm":
            specs["patch_embeddings"] = ((B, cfg.num_patches, d), bf16)
            specs["tokens"] = ((B, S - cfg.num_patches), i32)
            specs["mrope_positions"] = ((3, B, S), i32)
        else:
            specs["tokens"] = ((B, S), i32)
        if shape.kind == "train":
            specs["labels"] = ((B, S), i32)
    else:
        specs["tokens"] = ((B, 1), i32)
        specs["positions"] = ((B,), i32)
        specs["cache"] = T._cache_struct(cfg, B, S)
        if cfg.family == "encdec":
            specs["encoder_output"] = ((B, cfg.encoder_seq, d), bf16)
        if cfg.mrope:
            specs["mrope_positions"] = ((3, B, 1), i32)
    return specs


def synthesize_inputs(cfg: ModelConfig, shape: InputShape,
                      generator: Optional[torch.Generator] = None,
                      device="cpu") -> dict:
    """Random tensors of ``input_specs``' shapes and dtypes, drawn from
    ``generator`` (default: seed 0) in the order of the specs, on
    ``device``.  Integer leaves as in the reference: token and label ids
    in ``[0, vocab_size)``, every other integer (positions) in ``[0,
    max(1, seq_len))``; float leaves N(0, 1) * 0.02 drawn in f32, then
    cast.  (The reference folds a hash of each leaf's path into its key;
    the numbers differ, the shapes, dtypes and ranges do not.)  A
    generator on the card draws a leaf of more than two dims one slice of
    its leading axis at a time into the leaf (as ``modules.drawer``), so a
    full-size decode cache (51.5 GB at ``decode_32k`` for qwen2-0.5b) is
    never held as f32 or int64 whole."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gdev = generator.device

    def draw(path, shp, dtype):
        if not dtype.is_floating_point:
            hi = (cfg.vocab_size if "token" in path or "label" in path
                  else max(1, shape.seq_len))
            t = torch.randint(0, min(hi, 2 ** 30), shp, generator=generator,
                              device=gdev, dtype=torch.int64)
        else:
            t = torch.randn(shp, generator=generator, device=gdev,
                            dtype=torch.float32) * 0.02
        return t.to(device=device, dtype=dtype)

    def fill(path, spec):
        shp, dtype = spec
        if gdev.type == "cpu" or len(shp) <= 2:
            return draw(path, shp, dtype)
        out = torch.empty(shp, dtype=dtype, device=device)
        for part in out:
            part.copy_(draw(path, part.shape, dtype))
        return out

    def walk(prefix, tree):
        if isinstance(tree, dict):
            return {k: walk(f"{prefix}/{k}", v) for k, v in tree.items()}
        return fill(prefix, tree)

    return walk("", input_specs(cfg, shape))
