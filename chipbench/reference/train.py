"""The plain reference training step: next-token cross-entropy, its
gradients by autograd, clipping by the global norm and AdamW, in float32
with TF32 off (or the fp8 control, ``model.q8_matmul``).

``readings`` steps the reference from the same starting weights on the
same batches as the program and returns what the comparison reads: each
step's loss, every leaf's norm of the first gradient as the optimizer
gets it (after clipping), and every leaf's norm of the change of the
weights after the last step.  A step's rows run in blocks, their summed
losses over the whole step's token count back-propagated block by block,
so the gradient is the whole batch's mean whatever the block.

The loss: logits at position t predict the token at t + 1; the mean over
every row and every position but the last.  AdamW as ``optax.adamw``
writes it: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and the update
-lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) - lr wd w, after the
gradients are scaled by min(1, clip / (|g| + 1e-6)).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from chipbench.reference import model as M


def _tree(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, t in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _loss_sum(params, cfg, tokens: torch.Tensor, precision: str):
    logits = M.logits(params, cfg, tokens, precision)[:, :-1]
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, tokens[:, 1:, None].long()).sum()


def readings(params0, cfg: Dict, batches: Sequence[np.ndarray],
             opt: Dict, *, rows: int = 4, precision: str = "f32",
             half_batch: bool = False) -> Dict:
    """Step the reference over ``batches`` ((B, S) int token arrays) from
    ``params0`` (a tree of f32 tensors, left unchanged).  ``half_batch``:
    a broken step that drops the second half of every batch and takes the
    mean over the rest.  Returns ``{"losses", "grad_norms",
    "change_norms"}``, the norms by leaf path."""
    M.no_tf32()
    start = _flat(params0)
    flat = {k: v.detach().float().clone().requires_grad_(True)
            for k, v in start.items()}
    params = _tree(flat)
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["clip_norm"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(np.asarray(batch)).to(
            next(iter(flat.values())).device)
        if half_batch:
            tokens = tokens[:tokens.shape[0] // 2]
        n = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for r in range(0, tokens.shape[0], rows):
            part = _loss_sum(params, cfg, tokens[r:r + rows], precision) / n
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            norm = torch.sqrt(sum(p.grad.square().sum()
                                  for p in flat.values()))
            scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for k, p in flat.items():
                g = p.grad * scale
                if t == 1:
                    grad_norms[k] = float(g.norm())
                m[k].mul_(b1).add_(g * (1 - b1))
                v2[k].mul_(b2).add_(g * g * (1 - b2))
                upd = -lr * (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                if wd:
                    upd = upd - lr * wd * p
                p.add_(upd)
                p.grad = None
    with torch.no_grad():
        change = {k: float((flat[k] - start[k].float()).norm())
                  for k in flat}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def kept_leaves(ref_grad_norms: Dict[str, float],
                share: float = 1e-3) -> List[str]:
    """The leaves the comparison reads: those whose reference gradient is
    at least ``share`` of the median leaf's (a key's bias has a gradient
    that is nought to rounding under softmax, and moves under Adam by
    round-off alone)."""
    med = float(np.median(list(ref_grad_norms.values())))
    return sorted(k for k, g in ref_grad_norms.items() if g >= share * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each kept leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median kept leaf."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Sequence[str]):
    """The worst leaf's gap (``leaf_gaps``).  Returns ``(gap, leaf)``."""
    gaps = leaf_gaps(prog, ref, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Sequence[str]) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    return float(np.median(list(leaf_gaps(prog, ref, keep).values())))


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers the check reads, of the program's (or a control's)
    readings against the reference's: ``loss_gap``; ``grad_gap``, the
    median leaf's gap of the first gradient's norm, and
    ``grad_gap_worst``, the worst leaf's (most often the v bias's: a sum
    over every token with much cancellation); ``change_gap``, the worst
    leaf's gap of the weights' change."""
    keep = kept_leaves(ref["grad_norms"])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": median_leaf_gap(prog["grad_norms"],
                                        ref["grad_norms"], keep),
            "change_gap": leaf_gap(prog["change_norms"],
                                   ref["change_norms"], keep)[0],
            "grad_gap_worst": leaf_gap(prog["grad_norms"],
                                       ref["grad_norms"], keep)[0],
            "leaves": len(keep)}
