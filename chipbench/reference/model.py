"""The plain reference decoder: qwen2 (dense, QKV bias, tied embeddings)
and qwen3-moe (dropless top-k routed experts), in plain PyTorch.

It reads the weights the benchmark drew, in the port's parameter layout:
``layers/<leaf>`` stacked over (groups, pattern) whose product is the
layer count; a norm's ``scale`` with the gain ``1 + scale``; a product's
weight as (fan_in, *out), a bias beside it; the MoE block's f32 router
``(d, E)`` and expert-stacked ``wi``, ``wg`` ``(E, d, d_ff)`` and ``wo``
``(E, d_ff, d)``; ``embed/table`` (V, d), and ``lm_head/w`` (d, V) unless the
embeddings are tied.  The sizes come from the configuration file's
published keys.  Nothing of the program, and neither JAX nor the JAX
package, is imported.

Numbers: every value in float32 and every product in float32 with TF32
off (``precision="f32"``).  ``precision="fp8"`` is the control: every
product's operands rounded to float8 e4m3 first (activations scaled per
tensor, weights per output column, as an fp8 inference path would), with
f32 accumulation; in training the gradients entering a product are
rounded to float8 e5m2 (``q8_matmul``).

Decoder layer: x += attn(rmsnorm(x)); x += ffn(rmsnorm(x)); logits =
rmsnorm(x) @ W_out.  Attention: q, k, v products (+ bias), RoPE by halves
(rotate-half, inverse frequencies theta^(-i / (D/2))), causal softmax at
scale 1/sqrt(D), query head h reading kv head h // (H / KV), the output
product.  The gated MLP: (silu(x W_g) * (x W_i)) W_o.  The MoE block: a
softmax over the router's logits, the top k experts by a stable
descending sort (ties to the lower expert id), their probabilities
renormalised to sum to 1, and each token's output the weighted sum of its
k experts' gated MLPs: every routed expert computes, none is dropped (the
published model is dropless).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

F8_MAX = 448.0            # float8 e4m3's largest finite value
F8_GRAD_MAX = 57344.0     # float8 e5m2's


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, dim: Optional[int] = None,
       dtype=torch.float8_e4m3fn, fmax: float = F8_MAX) -> torch.Tensor:
    """``x`` rounded to float8 and back to f32, scaled so its largest
    magnitude (per tensor, or per slice along the reduced ``dim``) maps
    to the format's largest value."""
    a = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = fmax / a.clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Q8MatMul(torch.autograd.Function):
    """a (..., k) @ w (k, n) with both operands in float8 e4m3 forward and
    the incoming gradient in float8 e5m2 backward; f32 accumulation."""

    @staticmethod
    def forward(ctx, a, w):
        aq, wq = q8(a), q8(w, dim=0)
        ctx.save_for_backward(aq, wq)
        return aq @ wq

    @staticmethod
    def backward(ctx, g):
        aq, wq = ctx.saved_tensors
        gq = q8(g, dtype=torch.float8_e5m2, fmax=F8_GRAD_MAX)
        ga = gq @ wq.t()
        gw = aq.reshape(-1, aq.shape[-1]).t() @ gq.reshape(-1, gq.shape[-1])
        return ga, gw


def q8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Q8MatMul.apply(a, w)


def _mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    if precision == "fp8":
        return q8_matmul(a, w)
    return a @ w


class Sizes:
    """The sizes the reference needs, from a configuration file's keys."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KV = cfg["num_key_value_heads"]
        self.D = cfg.get("head_dim") or self.d // self.H
        self.L = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.tied = cfg["tie_word_embeddings"]
        self.E = cfg.get("num_experts", 0)
        self.K = cfg.get("num_experts_per_tok", 0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, D) f32; pos (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.float()[:, None] * inv[None]               # (S, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(leaf: torch.Tensor, L: int, l: int) -> torch.Tensor:
    return leaf.reshape(L, *leaf.shape[2:])[l]


def _lin(p: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    w = p["w"]
    y = _mm(x, w.reshape(w.shape[0], -1), precision)
    if "b" in p:
        y = y + p["b"].float().reshape(-1)
    return y


def attention(p: Dict, s: Sizes, h: torch.Tensor, precision: str):
    """Causal self-attention of h (B, S, d) f32."""
    B, S, _ = h.shape
    q = _lin(p["wq"], h, precision).view(B, S, s.H, s.D)
    k = _lin(p["wk"], h, precision).view(B, S, s.KV, s.D)
    v = _lin(p["wv"], h, precision).view(B, S, s.KV, s.D)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, s.theta), rope(k, pos, s.theta)
    G = s.H // s.KV
    q = q.view(B, S, s.KV, G, s.D).permute(0, 2, 3, 1, 4)     # B KV G S D
    k = k.permute(0, 2, 1, 3)[:, :, None]                      # B KV 1 S D
    v = v.permute(0, 2, 1, 3)[:, :, None]
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(s.D)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    o = torch.softmax(sc, dim=-1) @ v                          # B KV G S D
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, s.H * s.D)
    return _lin(p["wo"], o, precision)


def mlp(p: Dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    g = _lin(p["wg"], h, precision)
    i = _lin(p["wi"], h, precision)
    return _lin(p["wo"], torch.nn.functional.silu(g) * i, precision)


def moe(p: Dict, s: Sizes, h: torch.Tensor, precision: str) -> torch.Tensor:
    """The dropless routed experts of h (..., d) f32; the router's
    product stays f32 whatever ``precision``."""
    x = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(x @ p["router"]["w"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[:, :s.K] / vals[:, :s.K].sum(-1, keepdim=True)
    eidx = idx[:, :s.K].reshape(-1)
    order = torch.argsort(eidx, stable=True)
    tok = order // s.K
    counts = torch.bincount(eidx, minlength=s.E).tolist()
    w = gate.reshape(-1)[order]
    out = torch.zeros_like(x)
    start = 0
    for e, n in enumerate(counts):
        if n:
            t, we = tok[start:start + n], w[start:start + n]
            xe = x[t]
            y = _mm(torch.nn.functional.silu(_mm(xe, p["wg"][e], precision))
                    * _mm(xe, p["wi"][e], precision), p["wo"][e], precision)
            out = out.index_add(0, t, y * we[:, None])
        start += n
    return out.reshape(h.shape)


def layer_params(params: Dict, s: Sizes, l: int) -> Dict:
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _layer(t, s.L, l)
    return walk(params["layers"])


def _stack(params: Dict, s: Sizes, x: torch.Tensor, attend,
           precision: str) -> torch.Tensor:
    """The layers and the final norm over the residual x (..., d) f32;
    ``attend(p, h)`` is one layer's attention over its normed input."""
    for l in range(s.L):
        lp = layer_params(params, s, l)
        x = x + attend(lp["attn"], rmsnorm(x, lp["ln1"]["scale"], s.eps))
        h = rmsnorm(x, lp["ln2"]["scale"], s.eps)
        x = x + (moe(lp["moe"], s, h, precision) if "moe" in lp
                 else mlp(lp["mlp"], h, precision))
    return rmsnorm(x, params["final_norm"]["scale"], s.eps)


def hidden(params: Dict, cfg: Dict, tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """The final-norm hidden states (B, S, d) f32 of tokens (B, S)."""
    s = Sizes(cfg)
    x = params["embed"]["table"][tokens.long()].float()
    return _stack(params, s, x,
                  lambda p, h: attention(p, s, h, precision), precision)


def hidden_ragged(params: Dict, cfg: Dict, seqs, precision: str = "f32"):
    """The final-norm hidden states of each sequence in ``seqs`` (1-D
    token tensors of any lengths), each attending only itself; the
    feed-forward blocks run over all their tokens at once."""
    s = Sizes(cfg)
    lens = [len(t) for t in seqs]
    x = params["embed"]["table"][torch.cat(seqs).long()].float()

    def attend(p, h):
        return torch.cat([attention(p, s, part[None], precision)[0]
                          for part in torch.split(h, lens)])
    return list(torch.split(_stack(params, s, x, attend, precision), lens))


def unembed(params: Dict, cfg: Dict, x: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """f32 logits of final-norm hidden states x (..., d)."""
    if cfg["tie_word_embeddings"]:
        return _mm(x, params["embed"]["table"].t(), precision)
    return _mm(x, params["lm_head"]["w"], precision)


def logits(params: Dict, cfg: Dict, tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """f32 logits (B, S, V) of tokens (B, S)."""
    return unembed(params, cfg, hidden(params, cfg, tokens, precision),
                   precision)
