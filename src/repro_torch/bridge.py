"""Weight bridge between the reference's parameter tree and the port's.

The reference checkpoints a parameter pytree as ``{path: array}`` with
``/``-joined dict keys (``checkpoint/ckpt.py::_flatten_with_paths``), e.g.
``layers/attn/wq/w`` of shape ``(L // pat, pat, d_model, heads, head_dim)``.
The port's parameters are nested dicts of tensors with exactly that layout
(``init_linear``'s ``(d_in, *out)`` weights, stacked layer dims), so the
bridge only nests, converts and places — leaf for leaf, no transposes.

The one exception is the 3DGAN's conv kernels: the reference's are DHWIO
(channels last), the port's OIDHW (``F.conv3d``'s layout).
``gan_from_flat`` / ``gan_to_flat`` transpose them both ways; every other
leaf of the two GAN trees (``fc`` and the heads, ``(d_in, d_out)``, and the
biases) passes as is.

The caller flattens the reference's tree (the tests do it with the
reference's own helper), so this module never touches JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.moe import F32_SUFFIXES as _MOE_F32_SUFFIXES
from repro_torch.models.ssm import F32_LEAVES as _SSM_F32_LEAVES

# leaves the reference uses in f32 (norm scales, as ``1 + scale`` or as
# LayerNorm's gain, and LayerNorm's ``bias``, which no linear's bias
# (``b``) shares; the mamba2 conv, dt bias, A_log and D; the MoE router,
# whose last key ``w`` every linear shares, so it is matched on its
# path): never narrowed
_F32_LEAVES = ("scale", "bias") + _SSM_F32_LEAVES


def _keeps_f32(keys) -> bool:
    return (keys[-1] in _F32_LEAVES
            or any(tuple(keys[-len(s):]) == s for s in _MOE_F32_SUFFIXES))


def from_flat(flat: Mapping[str, np.ndarray], device="cpu",
              weight_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """``{path: ndarray}`` -> nested dict of tensors on ``device``.

    ``weight_dtype=None`` keeps every leaf's own dtype (the reference's
    f32 masters), so ``to_flat(from_flat(flat))`` is exact.  With a dtype
    (bf16), linear, bias and embedding leaves are held in it — the cast
    the reference makes on every call, made once — while norm scales and
    LayerNorm biases, the mamba2 leaves used in f32 and the MoE router
    stay f32."""
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        t = torch.from_numpy(np.array(arr, copy=True))
        if weight_dtype is not None and not _keeps_f32(keys):
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


def _is_conv_kernel(path: str, arr) -> bool:
    return path.endswith("/w") and arr.ndim == 5


def gan_from_flat(flat: Mapping[str, np.ndarray], device="cpu"
                  ) -> Dict[str, Any]:
    """A reference 3DGAN tree (generator or discriminator) as ``{path:
    ndarray}`` -> the port's tree: conv kernels DHWIO -> OIDHW."""
    return from_flat({
        p: np.ascontiguousarray(np.transpose(a, (4, 3, 0, 1, 2)))
        if _is_conv_kernel(p, a) else a for p, a in flat.items()}, device)


def gan_to_flat(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's 3DGAN tree -> ``{path: ndarray}`` in the reference's
    layout: conv kernels OIDHW -> DHWIO."""
    return {p: np.ascontiguousarray(np.transpose(a, (2, 3, 4, 1, 0)))
            if _is_conv_kernel(p, a) else a
            for p, a in to_flat(params).items()}
