"""Architecture config registry (the port's copy).

``--arch <id>`` ids use the reference's names (dashes); modules use
underscores.  Every entry exports CONFIG (the full-size numbers) and
SMOKE_CONFIG (the reduced same-family variant for CPU tests), identical to
the reference's.  The port carries the dense decoders its serving path
runs; the other families join with the slices that port them.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "qwen2-0.5b": "qwen2_0p5b",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    key = arch if arch in _MODULES else arch.replace("_", "-")
    if key not in _MODULES:
        key = {v: k for k, v in _MODULES.items()}.get(arch, key)
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
