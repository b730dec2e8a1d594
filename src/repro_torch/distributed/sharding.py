"""Sharding strategies: parameter / optimizer-state / batch / cache specs
per strategy, and the local shards they give (counterpart of
``repro.distributed.sharding``).

Strategies:
  dp       — Horovod data parallelism: weights replicated, the batch over
             every mesh axis;
  dp_tp    — the batch over ('pod', 'data'), tensor parallelism over
             'model' (heads / d_ff / experts / vocab); weights replicated
             over data;
  fsdp_tp  — dp_tp plus parameter and optimizer-state sharding over
             'data' (ZeRO-3).

A spec is a tuple with one entry per dim: None (replicated), an axis name,
or a tuple of axis names (the dim split over their product, row-major).
Specs come from the parameter's path (``/``-joined dict keys, as the
reference's ``_path_str``) and rank, rule for rule as in the reference:
leading stack dims are never sharded, the trailing dims follow Megatron's
rules (column-parallel in, row-parallel out), experts shard over 'model',
the vocabulary over 'model', and ``fit_spec`` drops an axis whose size
does not divide its dim.  A mesh is anything with ``shape`` ({axis:
size}) and ``axis_names``: ``hvd.Groups`` or ``launch.mesh.AbstractMesh``.

:func:`shard` cuts this rank's slice of every full leaf, :func:`unshard`
gathers the full leaves back, :func:`local_bytes` counts a rank's bytes.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

STRATEGIES = ("dp", "dp_tp", "fsdp_tp")

Spec = Tuple[Any, ...]


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _is_leaf(node) -> bool:
    return not isinstance(node, dict)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's or array's, or the first item of a
    ``(shape, dtype)`` pair (``configs.base.input_specs``)."""
    if isinstance(leaf, tuple):
        return tuple(leaf[0])
    return tuple(leaf.shape)


def _walk(fn, tree, path=()):
    if _is_leaf(tree):
        return fn("/".join(path), tree)
    return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}


def tree_zip(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if _is_leaf(tree):
        return fn(tree, specs)
    return {k: tree_zip(fn, v, specs[k]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _n_stack(path: str, cfg) -> int:
    """Number of leading scan/stack dims for a param leaf at ``path``."""
    if path.startswith("layers"):
        if cfg.family in ("dense", "vlm", "moe"):
            return 2                       # (groups, pattern, ...)
        if cfg.family == "hybrid":
            return 2                       # (groups, attn_every, ...)
        return 1                           # ssm / encdec decoder: (L, ...)
    if path.startswith("tail_layers"):
        return 1
    if path.startswith("encoder/layers"):
        return 1
    return 0                               # embed, norms, shared_attn, ...


def _trailing_spec(path: str, trailing_rank: int, cfg,
                   fsdp: bool) -> Spec:
    """Megatron-style spec for the physical (post-stack) dims."""
    d = "data" if fsdp else None
    leaf = path.split("/")

    def is_(*names):
        return any(n in leaf for n in names)

    # MoE experts: (E, d, f) / (E, f, d), expert parallel over model
    if is_("moe"):
        if leaf[-2] in ("wi", "wg") or leaf[-1] in ("wi", "wg"):
            return ("model", d, None)
        if leaf[-2] == "wo" or leaf[-1] == "wo":
            return ("model", None, d)
        if is_("router"):
            return (d, None)
    # attention
    if is_("attn", "cross_attn"):
        if leaf[-2] in ("wq", "wk", "wv"):
            if leaf[-1] == "w":            # (d, heads, dh): column parallel
                return (d, "model", None)
            return ("model", None)         # bias (heads, dh)
        if leaf[-2] == "wo":               # (h*dh, d): row parallel
            return ("model", d) if leaf[-1] == "w" else (None,)
    # dense MLP
    if is_("mlp"):
        if leaf[-2] in ("wi", "wg"):
            return (d, "model") if leaf[-1] == "w" else ("model",)
        if leaf[-2] == "wo":
            return ("model", d) if leaf[-1] == "w" else (None,)
    # Mamba2
    if is_("mamba"):
        if leaf[-2] == "in_proj":          # (d, 2di+2GN+H): column parallel
            return (d, "model") if leaf[-1] == "w" else ("model",)
        if leaf[-2] == "out_proj":         # (di, d): row parallel
            return ("model", d) if leaf[-1] == "w" else (None,)
        if leaf[-1] == "conv_w":           # (w, conv_dim)
            return (None, "model")
        if leaf[-1] == "conv_b":
            return ("model",)
        if leaf[-1] in ("dt_bias", "A_log", "D"):   # (H,)
            return ("model",)
        if leaf[-1] == "scale":            # gated-norm scale (di,)
            return ("model",)
    # embeddings / head
    if leaf[0] == "embed" or leaf[-2:] == ["embed", "table"]:
        return ("model", d)                # vocab over model, d over data
    if leaf[0] == "lm_head":
        return (d, "model")
    if "pos_embed" in leaf:
        return (None, d)
    # norms and everything else: replicated
    return tuple([None] * trailing_rank)


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes whose size does not divide the corresponding dim
    (kv_heads 2 cannot shard over a 16-way 'model' axis)."""
    fitted = []
    for i, entry in enumerate(tuple(spec)
                              + (None,) * (len(shape) - len(spec))):
        if entry is None:
            fitted.append(None)
            continue
        keep = []
        remaining = shape[i]
        for ax in _axes(entry):
            n = mesh.shape[ax]
            if remaining % n == 0:
                keep.append(ax)
                remaining //= n
        fitted.append(tuple(keep) if len(keep) > 1 else
                      (keep[0] if keep else None))
    return tuple(fitted)


def param_spec(path: str, shape: Tuple[int, ...], cfg, strategy: str,
               mesh) -> Spec:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{STRATEGIES}")
    if strategy == "dp":
        return ()
    fsdp = strategy == "fsdp_tp"
    ndim = len(shape)
    ns = _n_stack(path, cfg)
    trailing = _trailing_spec(path, ndim - ns, cfg, fsdp)
    spec = (None,) * ns + tuple(trailing)
    spec = (spec + (None,) * ndim)[:ndim]
    return fit_spec(spec, shape, mesh)


def params_pspec(params_struct, cfg, strategy: str, mesh):
    """Tree of specs matching a params tree (tensors, meta tensors or
    ``(shape, dtype)`` pairs)."""
    return _walk(lambda p, leaf: param_spec(p, _shape(leaf), cfg, strategy,
                                            mesh), params_struct)


def _structure(tree):
    if _is_leaf(tree):
        return None
    return {k: _structure(v) for k, v in tree.items()}


def opt_state_pspec(opt_state_struct, params_spec_tree):
    """Optimizer-state specs: a moment tree shaped like the params takes
    the param specs, anything else (the step count) is replicated."""
    params_structure = _structure(params_spec_tree)

    def per_key(v):
        if _structure(v) == params_structure:
            return params_spec_tree
        return _walk(lambda p, leaf: (), v)
    return {k: per_key(v) for k, v in opt_state_struct.items()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_pspec(batch_struct, mesh, cfg, shape, strategy: str = "dp_tp"):
    """Input specs for a train / prefill / decode batch dict.

    Under ``dp`` every rank is a Horovod rank and the batch shards over
    all mesh axes; under ``*_tp`` the 'model' axis carries tensor
    parallelism and the batch shards over (pod, data) only; a batch that
    does not split over them stays whole on every rank."""
    daxes = all_axes(mesh) if strategy == "dp" else data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh.shape[a]
    B = shape.global_batch
    batch_shardable = B % dsize == 0 and B >= dsize

    def spec_for(p, leaf):
        nd = len(_shape(leaf))
        if p.startswith("cache"):
            # cache leaves: (*stack, B, S, KV, dh) attn | (*stack, B, H, N,
            # P) ssm | (*stack, B, w-1, conv) conv
            is_attn = p.endswith("/k") or p.endswith("/v")
            is_ssm = p.endswith("/ssm")
            stack = nd - (4 if (is_attn or is_ssm) else 3)
            lead = (None,) * stack
            batch_ax = daxes if batch_shardable else None
            if is_attn:
                kv_heads = _shape(leaf)[-2]
                kv_fits = kv_heads % mesh.shape["model"] == 0
                seq_axes = () if batch_shardable else daxes
                if kv_fits:
                    # heads over model (+ the sequence over data at B = 1)
                    return lead + (batch_ax, seq_axes or None, "model",
                                   None)
                # kv heads do not divide the model axis: the sequence over
                # 'model' instead
                seq = tuple(seq_axes) + ("model",)
                return lead + (batch_ax, seq if len(seq) > 1 else seq[0],
                               None, None)
            if is_ssm:
                return lead + (batch_ax, "model", None, None)
            return lead + (batch_ax, None, "model")      # conv state
        if p == "mrope_positions":                       # (3, B, S)
            return (None, daxes if batch_shardable else None, None)
        # tokens / labels / positions / embeddings: batch-major
        lead = daxes if batch_shardable else None
        return (lead,) + (None,) * (nd - 1)

    return _walk(lambda p, leaf: fit_spec(spec_for(p, leaf), _shape(leaf),
                                          mesh), batch_struct)


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------

def _coord(groups, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's index, count) over ``axes``, row-major in their
    order."""
    idx, n = 0, 1
    for a in axes:
        g = groups[a]
        idx, n = idx * g.size + g.rank, n * g.size
    return idx, n


def shard(tree, specs, groups):
    """This rank's slice of every full leaf (a copy; a leaf whose spec
    splits nothing is returned as it is)."""
    def one(t, spec):
        out = t
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                continue
            idx, n = _coord(groups, axes)
            size = t.shape[dim] // n
            if size * n != t.shape[dim]:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split over {axes}")
            out = out.narrow(dim, idx * size, size)
        return out if out is t else out.clone()
    return tree_zip(one, tree, specs)


def unshard(tree, specs, groups):
    """Every leaf whole: the shards all-gathered over each split dim's
    axes (a collective: every rank calls it)."""
    from repro_torch.core import hvd

    def one(t, spec):
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if axes:
                t = hvd.gather_dim(t, dim, groups[axes])
        return t
    return tree_zip(one, tree, specs)


def local_shape(spec: Spec, shape: Tuple[int, ...], mesh_shape
                ) -> Tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[dim] //= mesh_shape[a]
    return tuple(out)


def _itemsize(leaf) -> int:
    dtype = leaf[1] if isinstance(leaf, tuple) else leaf.dtype
    return torch.empty((), dtype=dtype).element_size()


def local_bytes(specs, shapes, mesh_shape) -> int:
    """The bytes one rank holds of a tree of ``shapes`` (tensors, meta
    tensors or ``(shape, dtype)`` pairs) laid out by ``specs`` over a mesh
    of ``mesh_shape`` ({axis: size}; every rank holds as much, since
    ``fit_spec`` keeps only axes that divide)."""
    total = 0

    def one(leaf, spec):
        nonlocal total
        n = 1
        for s in local_shape(spec, _shape(leaf), mesh_shape):
            n *= s
        total += n * _itemsize(leaf)
    tree_zip(one, shapes, specs)
    return total


def replication(spec: Spec, mesh_shape) -> int:
    """How many ranks hold each element of a leaf laid out by ``spec``."""
    used = {a for e in spec for a in _axes(e)}
    n = 1
    for a, s in mesh_shape.items():
        if a not in used:
            n *= s
    return n


def axes_of(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits a dim over."""
    return tuple(a for e in spec for a in _axes(e))


def model_dim(spec: Optional[Spec], axis: str = "model") -> Optional[int]:
    """The dim of a leaf that ``spec`` splits over ``axis``, counted from
    the last (negative, so a stacked leaf's spec serves one layer's slice
    of it), or None."""
    if not spec:
        return None
    n = len(spec)
    for i, e in enumerate(spec):
        if axis in _axes(e):
            return i - n
    return None
