"""Low-level modules as plain functions on tensors (params are dicts).

Counterpart of ``repro.models.modules``.  Weights keep the reference's
layout: a linear weight is ``(d_in, *out)`` (``init_linear``), a norm scale
is ``(d,)`` used as ``1 + scale`` in f32, the embedding table is
``(vocab, d)`` and doubles as the tied unembedding.  Compute happens in the
config's dtype (bf16): weights are cast to it on every call exactly as the
reference casts its f32 masters, so holding them in bf16 already gives the
same numbers with one cast fewer.

Tensor parallelism over the mesh's ``model`` axis (``dp_tp``,
``fsdp_tp``): a block that runs sharded is given a :class:`Shards`, its
params' specs (``distributed.sharding``) and this rank's groups, and its
params are this rank's slices.  A column-parallel product is ``linear`` on
the local columns of an input that entered the sharded region through
``Shards.copy_in`` (Megatron's f: its backward all_reduces the ranks'
partial gradients); a row-parallel one (:func:`row_linear`) takes its
slice of the input's contracted dim and all_reduces its partial sums
(Megatron's g).  The embedding, the tied or untied unembedding and the
cross-entropy are vocab-parallel where the vocabulary splits over
``model`` (:func:`embed`, :func:`unembed`, :func:`vocab_parallel_nll`).
Without a ``Shards`` (``dp``) every function is the one it always was.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.unembed import TiedUnembed


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """In-place truncated normal on [-2, 2] standard deviations (the
    reference's ``truncated_normal_init``; its numbers differ, the
    distribution does not)."""
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return t.mul_(stddev)


def drawer(generator: torch.Generator, device, dtype: torch.dtype):
    """``draw(shape, std, f32=False)``: one truncated-normal leaf on
    ``device`` in ``dtype`` (f32 where ``f32``), drawn on the generator's
    device.  A CPU generator draws each leaf whole in f32.  A generator on
    the card draws a leaf of more than two dims one slice of its leading
    axis at a time, in f32, into the leaf preallocated in its dtype: a
    full-width qwen3-moe (30.5 B parameters) is made in seconds, and no
    whole stacked leaf (38.6 GB as f32 for its experts) is ever held in
    f32.  The two differ because slices give other numbers than one whole
    draw: ``trunc_normal_`` (torch 2.13) rejects out-of-range values and
    redraws them over the whole tensor, so a CPU draw stays whole to keep
    the weights every earlier seed gave.  On the ``meta`` device nothing
    is drawn: the leaves have shapes and dtypes only (``params_struct``)."""
    def meta(shape, std, f32=False):
        return torch.empty(shape, dtype=torch.float32 if f32 else dtype,
                           device="meta")

    def whole(shape, std, f32=False):
        t = truncated_normal_(torch.empty(shape, dtype=torch.float32), std,
                              generator)
        return t.to(device, torch.float32 if f32 else dtype)

    def sliced(shape, std, f32=False):
        out = torch.empty(shape, dtype=torch.float32 if f32 else dtype,
                          device=device)
        for part in (out if out.dim() > 2 else (out,)):
            t = torch.empty(part.shape, dtype=torch.float32,
                            device=generator.device)
            part.copy_(truncated_normal_(t, std, generator))
        return out
    if torch.device(device).type == "meta":
        return meta
    return whole if generator.device.type == "cpu" else sliced


# ---------------------------------------------------------------------------
# Sharded params: the blocks' view of the mesh
# ---------------------------------------------------------------------------

class Shards:
    """How a block's params lie over the mesh while it runs: ``specs``,
    the spec subtree of the block's params (stack dims included; a dim is
    looked up counted from the last, so one layer's slice of a stacked
    leaf reads its stacked spec), this rank's ``model`` group and, under
    ``fsdp_tp``, its ``data`` group (the params arrive as ``data`` shards
    and :meth:`gather` makes them whole along that axis).  ``batch``: the
    group of the data axes the batch splits over, for statistics of the
    whole global batch (:meth:`batch_mean`).  For the serve step
    (``transformer.decode_step``): ``groups``, the whole layout
    (``hvd.Groups``), and ``cache``, the dense cache's spec tree, both
    handed down unchanged by indexing."""

    def __init__(self, specs, model, data=None, batch=None, groups=None,
                 cache=None):
        self.specs, self.model, self.data = specs, model, data
        self.batch, self.groups, self.cache = batch, groups, cache

    def __getitem__(self, key) -> "Shards":
        return Shards(self.specs[key], self.model, self.data, self.batch,
                      self.groups, self.cache)

    def dim(self, *keys, axis: str = "model") -> Optional[int]:
        """The dim of leaf ``keys`` split over ``axis`` (negative), or
        None."""
        from repro_torch.distributed.sharding import model_dim
        spec = self.specs
        for k in keys:
            spec = spec[k]
        return model_dim(spec, axis)

    def gather(self, p):
        """``p`` with every leaf split over ``data`` all-gathered along
        that dim (FSDP; the backward reduce-scatters the gradient).  The
        identity without a ``data`` group (``dp_tp``)."""
        return self._whole(p, self.specs, ("data",))

    def replicate(self, p):
        """``p`` made whole over ``data`` and ``model``: for a block that
        has no tensor-parallel form (the mamba2 layer), which then runs
        replicated on every ``model`` rank (the ``model`` gather's
        backward keeps this rank's slice of the replicated gradient)."""
        return self._whole(p, self.specs, ("data", "model"))

    def _whole(self, p, specs, axes):
        from repro_torch.core import hvd
        from repro_torch.distributed.sharding import model_dim
        if isinstance(p, dict):
            return {k: self._whole(v, specs[k], axes) for k, v in p.items()}
        for axis in axes:
            d = model_dim(specs, axis)
            if d is None:
                continue
            if axis == "data" and self.data is not None:
                p = hvd.all_gather_dim(p, d, self.data)
            elif axis == "model":
                p = hvd.gather_from_group(p, d, self.model)
        return p

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering the sharded region (Megatron's
        f)."""
        from repro_torch.core import hvd
        return hvd.copy_to_group(x, self.model)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' partial sums all_reduced (Megatron's g)."""
        from repro_torch.core import hvd
        return hvd.reduce_from_group(x, self.model)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a replicated ``x`` along ``dim`` (the
        backward all-gathers the slices' gradients)."""
        from repro_torch.core import hvd
        return hvd.scatter_to_group(x, dim, self.model)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s mean over the batch's data ranks (the identity without
        a ``batch`` group)."""
        from repro_torch.core import hvd
        if self.batch is None:
            return x
        return hvd.mean_over_group(x, self.batch)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import hvd
        return hvd.all_reduce_max(x, self.model)

    def vocab_start(self, local_vocab: int) -> int:
        return self.model.rank * local_vocab


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear(p, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """x (..., d_in) @ w (d_in, *out) [+ b] -> (..., *out).  With ``dtype``
    both operands are cast to it and the product comes out in it (f32
    accumulation inside the matmul, as ``preferred_element_type=x.dtype``
    gives in the reference)."""
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    out_shape = w.shape[1:]
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *out_shape)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def row_linear(p, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
               sh: Optional[Shards] = None) -> torch.Tensor:
    """A row-parallel product: where ``sh`` splits w's rows (the
    contracted dim) over ``model``, this rank's slice of x's last dim
    (taken from x when x holds all of it, whatever x's own sharding) times
    the local rows, the partial sums all_reduced, then the bias.  Without
    that split, ``linear``."""
    if sh is None or sh.dim("w") is None:
        return linear(p, x, dtype)
    if x.shape[-1] != p["w"].shape[0]:
        x = sh.split(x, -1)
    y = sh.reduce_out(linear({"w": p["w"]}, x, dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` gain, in f32; the result comes out
    in ``out_dtype`` (default: x's dtype).  Runs the fused kernel
    (``kernels.ops.rmsnorm``) on a CUDA tensor, its plain version on a
    CPU tensor."""
    return ops.rmsnorm(x, p["scale"], eps=eps, out_dtype=out_dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm (whisper): (x - mean) * rsqrt(var + eps) * scale + bias,
    all in f32 (the biased variance, as ``jnp.var``), the result in
    ``out_dtype`` (default: x's dtype).  No TPU kernel computes it, so
    this plain version is the port, as the reference's jnp is."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed(p, tokens: torch.Tensor, dtype: Optional[torch.dtype] = None,
          sh: Optional[Shards] = None):
    """Rows of the table.  Vocab-parallel where ``sh`` splits the table's
    rows over ``model``: each rank looks up the tokens it holds, zeros
    elsewhere, and the rows are all_reduced (one nonzero term each, so
    exact)."""
    if sh is None or sh.dim("table") is None:
        rows = p["table"][tokens]
        return rows if dtype is None else rows.to(dtype)
    table = p["table"]
    n = table.shape[0]
    local = tokens.long() - sh.vocab_start(n)
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    if dtype is not None:
        rows = rows.to(dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return sh.reduce_out(rows)


def unembed(p, x: torch.Tensor, sh: Optional[Shards] = None
            ) -> torch.Tensor:
    """Tied unembedding: table cast to x's dtype, f32 accumulation, f32
    logits (the reference's ``preferred_element_type=float32``).  The
    products of two bf16 values are exact in f32: bf16 x on the card (and
    on ``meta``) runs ``kernels.unembed.TiedUnembed``, the products on the
    tensor cores; f32 x, and the CPU, an f32 matmul of the cast operands.
    Where ``sh`` splits the vocabulary over ``model``: this rank's slice
    of the logits (column-parallel)."""
    if sh is not None and sh.dim("table") is not None:
        x = sh.copy_in(x)
    if x.dtype == torch.bfloat16 and x.device.type in ("cuda", "meta"):
        return TiedUnembed.apply(x, p["table"].to(x.dtype))
    table = p["table"].to(x.dtype).float()
    return torch.matmul(x.float(), table.t())


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       sh: Shards) -> torch.Tensor:
    """Per-position -log softmax(logits)[target] over a vocabulary split
    over ``model``: ``logits`` (..., V / m) f32 is this rank's slice,
    ``targets`` (...) the global ids.  The row max (all_reduced by max,
    no gradient) and the sum of exponentials (all_reduced) cover the
    whole vocabulary; the target logit comes from the rank that holds it
    (zeros elsewhere, all_reduced)."""
    n = logits.shape[-1]
    mx = sh.all_max(logits.detach().amax(dim=-1))
    sumexp = sh.reduce_out(torch.exp(logits - mx[..., None]).sum(dim=-1))
    local = targets.long() - sh.vocab_start(n)
    inside = (local >= 0) & (local < n)
    hit = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    hit = sh.reduce_out(torch.where(inside, hit, torch.zeros_like(hit)))
    return torch.log(sumexp) + mx - hit


# ---------------------------------------------------------------------------
# Activations / misc
# ---------------------------------------------------------------------------

# The activations run op for op in x's dtype, with constants rounded to it
# first, as the reference's jnp definitions do: in bf16 each op rounds its
# result, and a fused f32 evaluation rounded once differs in ~40% of values.

_consts: Dict[Tuple[float, torch.dtype, torch.device], torch.Tensor] = {}


def const(v: float, x: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to x's dtype, as a 0-d tensor on x's device.  Made
    once per (value, dtype, device) and kept: making it copies from
    pageable host memory, which a CUDA graph capture forbids, so a
    captured program's warm-up run makes every constant its capture
    reads, and the graph reads it at that address on every replay."""
    key = (v, x.dtype, x.device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(v, dtype=x.dtype, device=x.device)
    return t


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``."""
    inner = const(math.sqrt(2.0 / math.pi), x) * (
        x + const(0.044715, x) * (x ** 3))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def activation(name: str):
    return {"silu": silu, "gelu": gelu_tanh, "relu": torch.relu}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp(p, x: torch.Tensor, act: str = "silu",
        dtype: Optional[torch.dtype] = None,
        sh: Optional[Shards] = None) -> torch.Tensor:
    """The gated MLP; under ``sh``, ``wi`` / ``wg`` column-parallel and
    ``wo`` row-parallel over ``model`` (where d_ff splits)."""
    a = activation(act)
    if sh is not None and sh.dim("wi", "w") is not None:
        x = sh.copy_in(x)
    h = a(linear(p["wg"], x, dtype)) * linear(p["wi"], x, dtype)
    return row_linear(p["wo"], h, dtype, None if sh is None else sh["wo"])
