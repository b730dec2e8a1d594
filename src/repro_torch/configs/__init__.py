"""Architecture config registry (the port's copy).

``--arch <id>`` ids use the reference's names (dashes); modules use
underscores.  Every entry exports CONFIG (the full-size numbers) and
SMOKE_CONFIG (the reduced same-family variant for CPU tests), identical to
the reference's.  The port carries all ten of the reference's
architectures: the dense decoders (qwen2-0.5b, gemma2-2b, gemma2-27b,
deepseek-coder-33b), the moe family (qwen3-moe, dbrx), the ssm family
(mamba2), the hybrid family (zamba2), the vlm family (qwen2-vl) and the
encdec family (whisper), and the paper's 3DGAN (``gan3d``, kept out of
``ARCHS`` as in the reference).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "whisper-small": "whisper_small",
    "gemma2-27b": "gemma2_27b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-0.5b": "qwen2_0p5b",
    "mamba2-1.3b": "mamba2_1p3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gan3d": "gan3d",
}

ARCHS: List[str] = [a for a in _MODULES if a != "gan3d"]


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


def default_strategy(cfg: ModelConfig) -> str:
    """The reference's baseline strategy: tensor parallelism (``dp_tp``)
    for a model of fewer than 20 B parameters, FSDP plus tensor
    parallelism (``fsdp_tp``) from 20 B up."""
    return "fsdp_tp" if cfg.param_count() >= 20e9 else "dp_tp"


__all__ = ["ARCHS", "ModelConfig", "default_strategy", "get_config",
           "get_smoke_config"]
