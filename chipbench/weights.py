"""Weights drawn from ``--seed``, in the port's parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference.  The layout (the nested dict of leaves,
their shapes and dtypes) is the port's own, read from its ``init_params``
on the ``meta`` device, where nothing is drawn; every number is drawn here,
one ``torch.randn`` call a leaf on a generator on the run's device, in the
dtype the leaf is held in, leaves in sorted path order.  The same seed on
the same device gives the same weights.

Scales: every product's weights at 1 / sqrt(fan-in), the embedding and the
biases at 0.02, and the norms' ``scale`` (the gain is ``1 + scale``) at
0.1, so that the gains and the biases are exercised too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _std(path: str, shape) -> float:
    parts = path.split("/")
    name = parts[-1]
    if name == "scale":
        return 0.1
    if name == "b" or parts[0] == "embed":
        return 0.02
    if parts[0] == "lm_head":
        return 1.0 / math.sqrt(shape[0])
    if "moe" in parts and name in ("wi", "wg", "wo"):
        return 1.0 / math.sqrt(shape[-2])       # (..., E, fan_in, fan_out)
    return 1.0 / math.sqrt(shape[2])            # (groups, pattern, fan_in, ..)


def _set(tree: Dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def draw_each(layout, seed: int, device) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of the weights shaped and typed as ``layout`` (a
    tree of ``meta`` tensors), drawn on ``device`` from ``seed``, one at a
    time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for path, spec in leaves(layout):
        t = torch.randn(tuple(spec.shape), generator=gen, device=device,
                        dtype=spec.dtype)
        yield path, t.mul_(_std(path, spec.shape))


def draw(layout, seed: int, device) -> Dict[str, Any]:
    """The whole tree of :func:`draw_each`."""
    out: Dict[str, Any] = {}
    for path, t in draw_each(layout, seed, device):
        _set(out, path, t)
    return out


def port_layout(cfg, weight_dtype):
    """The port's parameter tree for ``cfg`` on the ``meta`` device."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, torch.Generator(), device="meta",
                         weight_dtype=weight_dtype)


def seed_of(seed: int) -> int:
    """A generator seed for any whole number (negative ones wrap)."""
    return int(seed) % (2 ** 63)
