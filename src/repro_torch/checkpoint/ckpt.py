"""Checkpoints of nested dicts of tensors, in the reference's layout.

Counterpart of ``repro.checkpoint.ckpt``.  A checkpoint is a directory

    step_000000123/
        manifest.json   (step, every leaf's shape and dtype, extra)
        arrays.npz      (leaves keyed by their ``/``-joined dict path)

with the reference's keys (``layers/attn/wq/w``, ``opt/mu/embed/table``,
...), so a checkpoint written by one package restores in the other.  bf16
leaves are stored widened to f32 (``np.savez`` has no bf16) and the
manifest keeps their dtype; ``restore`` casts each leaf to the dtype of the
matching leaf of ``like``.  Writes go to a temporary directory renamed into
place, so a killed job never leaves half a checkpoint; the ``keep`` newest
are kept.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: tensor}`` in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(_flatten_with_paths(tree[k], _path(prefix, k)))
    return out


def _to_numpy(t: torch.Tensor):
    """A tensor as (array to store, dtype name for the manifest)."""
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name


def save(ckpt_dir, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    dest = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    manifest_ = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in _flatten_with_paths(tree).items():
        arr, dtype = _to_numpy(leaf)
        manifest_["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[key] = arr
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest_, indent=2))
    if dest.exists():
        shutil.rmtree(dest)
    os.rename(tmp, dest)
    old = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in old[:-keep]:
        shutil.rmtree(p)
    return dest


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def _unflatten_like(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, _path(prefix, k))
                for k, v in like.items()}
    return flat[prefix]


def restore(ckpt_dir, like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like`` (nested dicts of tensors):
    each leaf takes the dtype and device of ``like``'s leaf."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:09d}"
    with np.load(src / "arrays.npz") as data:
        wanted = _flatten_with_paths(like)
        missing = [k for k in wanted if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint {src} missing leaves: "
                           f"{missing[:5]}...")
        flat = {k: torch.from_numpy(data[k]).to(device=leaf.device,
                                                dtype=leaf.dtype)
                for k, leaf in wanted.items()}
    return _unflatten_like(like, flat)


def manifest(ckpt_dir, step: Optional[int] = None) -> dict:
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    return json.loads(
        (ckpt_dir / f"step_{step:09d}" / "manifest.json").read_text())
