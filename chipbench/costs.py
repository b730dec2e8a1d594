"""The yardstick's arithmetic: peaks, a kernel's bytes and operations, and
the model operations a token needs.

Everything here counts the work that the inputs need, whatever implements
it: a MoE token's ``num_experts_per_tok`` routed experts (not every
expert that an all-experts dispatch computes), real prompt tokens (not
padded rows), and a kernel's inputs read once and outputs written once.
A later kernel that computes less or reads less can then never push a
share past 100%.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates): 989 TFLOP/s
in bf16 on the tensor cores and 3.35 TB/s of HBM.  A share is stated
against them, with the card's power limit beside it.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12          # FLOP/s, H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12         # bytes/s, H100 SXM


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def decode_cost(q_shape: Tuple[int, int, int, int], pps: int,
                lengths: Sequence[int], itemsize: int = 2
                ) -> Tuple[int, int]:
    """(bytes, flops) one paged decode call needs: ``q_shape`` (B, KV, G,
    D), ``pps`` table entries a row, ``lengths`` each row's attended
    positions.  q read and the output written once, the K and V of each
    row's own positions read once, each row's length and table row (int32)
    once; 4 flops per (query head, attended position, dim).  A frozen copy
    of the port's ``serving.profiling.decode_cost`` (its
    ``kernels.paged_attention.cost``), without a window."""
    B, KV, G, D = q_shape
    pos = sum(lengths)
    q_bytes = B * KV * G * D * itemsize
    nbytes = 2 * q_bytes + pos * KV * D * itemsize * 2 + B * 4 * (1 + pps)
    return nbytes, 4 * pos * KV * G * D


def causal_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs a causal flash call attends: query t sees keys
    ``<= t``."""
    return sum(min(t + 1, Skv) for t in range(Sq))


def flash_fwd_cost(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
                   itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one causal flash forward: q, k, v read once, the
    output and the f32 log-sum-exp written once; 4 flops per (query head,
    attended key, dim)."""
    nbytes = (itemsize * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
              + 4 * B * H * Sq)
    return nbytes, 4 * B * H * D * causal_pairs(Sq, Skv)


class ModelFlops:
    """Operations a decoder needs per token, from the sizes of a
    configuration file (its published keys).

    ``matmul_params``: the parameters a token multiplies by in one layer
    (q, k, v, o, and the gated MLP or the router and the routed
    experts); ``unembed_params`` the output projection's.  A product of
    n parameters costs 2 n flops forward; attention 4 H D flops per
    attended position and layer forward."""

    def __init__(self, cfg: Dict):
        d = cfg["hidden_size"]
        H = cfg["num_attention_heads"]
        KV = cfg["num_key_value_heads"]
        D = cfg.get("head_dim") or d // H
        self.layers = cfg["num_hidden_layers"]
        self.heads, self.head_dim = H, D
        attn = d * H * D + 2 * d * KV * D + H * D * d
        if cfg.get("num_experts"):
            E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
            ffn = d * E + K * 3 * d * cfg["moe_intermediate_size"]
        else:
            ffn = 3 * d * cfg["intermediate_size"]
        self.matmul_params = attn + ffn
        self.unembed_params = d * cfg["vocab_size"]

    def attn_flops(self, positions: float) -> float:
        """Forward attention flops of one token attending ``positions``
        keys in every layer."""
        return 4.0 * self.heads * self.head_dim * positions * self.layers

    def token_fwd(self, context: int) -> float:
        """Forward flops of one served token at 0-based ``context`` (it
        attends ``context + 1`` positions), its output projection
        included."""
        return (2.0 * (self.matmul_params * self.layers
                       + self.unembed_params)
                + self.attn_flops(context + 1))

    def prompt_tokens_fwd(self, tokens: int, mean_context: float) -> float:
        """Forward flops of ``tokens`` prompt tokens whose mean attended
        positions are ``mean_context`` (no output projection)."""
        return (2.0 * self.matmul_params * self.layers * tokens
                + self.attn_flops(mean_context) * tokens)

    def train_step(self, batch: int, seq: int) -> float:
        """Model flops of one training step: 6 flops per matmul parameter
        (the tied or untied output projection included) per token, plus
        attention forward and backward (3 x forward) at the causal mean
        context.  Recompute under remat is not counted."""
        tokens = batch * seq
        dense = 6.0 * (self.matmul_params * self.layers
                       + self.unembed_params) * tokens
        return dense + 3.0 * self.attn_flops((seq + 1) / 2.0) * tokens
