"""Weight bridge between the reference's parameter tree and the port's.

The reference checkpoints a parameter pytree as ``{path: array}`` with
``/``-joined dict keys (``checkpoint/ckpt.py::_flatten_with_paths``), e.g.
``layers/attn/wq/w`` of shape ``(L // pat, pat, d_model, heads, head_dim)``.
The port's parameters are nested dicts of tensors with exactly that layout
(``init_linear``'s ``(d_in, *out)`` weights, stacked layer dims), so the
bridge only nests, converts and places — leaf for leaf, no transposes.

The caller flattens the reference's tree (the tests do it with the
reference's own helper), so this module never touches JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# leaves used as ``1 + scale`` in f32: never narrowed
_F32_LEAVES = ("scale",)


def from_flat(flat: Mapping[str, np.ndarray], device="cpu",
              weight_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """``{path: ndarray}`` -> nested dict of tensors on ``device``.

    ``weight_dtype=None`` keeps every leaf's own dtype (the reference's
    f32 masters), so ``to_flat(from_flat(flat))`` is exact.  With a dtype
    (bf16), linear, bias and embedding leaves are held in it — the cast
    the reference makes on every call, made once — while norm scales stay
    f32."""
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        t = torch.from_numpy(np.array(arr, copy=True))
        if weight_dtype is not None and keys[-1] not in _F32_LEAVES:
            t = t.to(weight_dtype)
        node[keys[-1]] = t.to(device)
    return tree


def to_flat(params: Mapping[str, Any], prefix: str = ""
            ) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> ``{path: ndarray}`` (bf16 leaves widened
    to f32, as the reference's checkpoints store them)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(to_flat(v, path))
        else:
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[path] = t.numpy()
    return out
