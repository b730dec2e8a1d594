"""Optimizers as plain functions over parameter dicts (counterpart of
``repro.optim.optimizers``).

``update(grads, state, params) -> (updates, state)`` as in the reference:
states are nested dicts of f32 tensors plus an int32 step ``count``, laid
out exactly as the reference's (``{"count", "mu", "nu"}`` for Adam), so a
checkpoint of one package's optimizer state restores in the other.
Updates come back in f32 and ``apply_updates`` adds them to the params in
f32, then casts to each param's dtype.  The learning rate of an update is
the schedule at the count *before* the increment, as in the reference.
``update`` updates nothing in place: every call returns new tensors.
AdamW also has ``update_in_place(grads, state, params)``, the
counterpart of the reference's donated train step (``donate_argnums``):
the same arithmetic, op for op (so the same bits), written leaf by leaf
into the params, ``mu`` and ``nu`` (and the clip into the grads), so a
step holds no second copy of any of them; the training step
(``stepfn.make_train_step``) uses it wherever an optimizer has one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    """Leaves in the reference's order (``jax.tree.leaves`` sorts dict
    keys), so sums over leaves add in the same order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _lr_at(lr: ScalarOrSchedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    return torch.tensor(lr, dtype=torch.float32, device=count.device)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is the caller's where the gradients are shards (the sharded train
    step's norm over every rank), else this tree's."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# elements an in-place update takes at a time (its f32 temporaries: 256 MB
# each)
IN_PLACE_CHUNK = 1 << 26


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, norm=None) -> (updates, state); ``norm``: the
    # gradients' global norm for clipping where the caller has it (shards)
    update: Callable[..., Tuple[Any, Any]]
    # (grads, state, params, norm=None) -> None: the update applied in
    # place, where the optimizer has one
    update_in_place: Optional[Callable[..., None]] = None


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _count(params) -> torch.Tensor:
    dev = next(_leaves(params)).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32(tree):
    return tree_map(lambda g: g.float(), tree)


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------

def sgd(lr: ScalarOrSchedule, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        s = {"count": _count(params)}
        if momentum:
            s["mu"] = _zeros_like_f32(params)
        return s

    def update(grads, state, params, norm=None):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        step_lr = _lr_at(lr, state["count"])
        g32 = _f32(grads)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], g32)
            upd = tree_map(lambda m: -step_lr * m, mu)
            return upd, {"count": state["count"] + 1, "mu": mu}
        return tree_map(lambda g: -step_lr * g, g32), \
            {"count": state["count"] + 1}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# RMSProp (the paper's 3DGAN optimizer)
# ---------------------------------------------------------------------------

def rmsprop(lr: ScalarOrSchedule, decay: float = 0.9, eps: float = 1e-8,
            clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return {"count": _count(params), "nu": _zeros_like_f32(params)}

    def update(grads, state, params, norm=None):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        step_lr = _lr_at(lr, state["count"])
        g32 = _f32(grads)
        nu = tree_map(lambda n, g: decay * n + (1 - decay) * g * g,
                      state["nu"], g32)
        upd = tree_map(lambda g, n: -step_lr * g / (torch.sqrt(n) + eps),
                       g32, nu)
        return upd, {"count": state["count"] + 1, "nu": nu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

def adamw(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = None) -> Optimizer:
    def init(params):
        return {"count": _count(params), "mu": _zeros_like_f32(params),
                "nu": _zeros_like_f32(params)}

    def update(grads, state, params, norm=None):
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        count = state["count"] + 1
        step_lr = _lr_at(lr, state["count"])
        g32 = _f32(grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], g32)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g,
                      state["nu"], g32)
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c

        def u(m, n, p):
            upd = -step_lr * (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay:
                upd = upd - step_lr * weight_decay * p.float()
            return upd

        upd = tree_map(u, mu, nu, params)
        return upd, {"count": count, "mu": mu, "nu": nu}

    def update_in_place(grads, state, params, norm=None):
        """``update`` then ``apply_updates``, written into ``params``,
        ``state`` and ``grads`` leaf by leaf with the same ops in the same
        order, each leaf in chunks of ``IN_PLACE_CHUNK`` elements (every
        leaf is contiguous)."""
        if clip_norm:
            if norm is None:
                norm = global_norm(grads)
            scale = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
        step_lr = _lr_at(lr, state["count"])
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        neg_lr = -step_lr
        for leaf in zip(_leaves(grads), _leaves(state["mu"]),
                        _leaves(state["nu"]), _leaves(params)):
            # elementwise, so chunk by chunk: the temporaries stay small
            for g, m, n, p in zip(*(t.view(-1).split(IN_PLACE_CHUNK)
                                    for t in leaf)):
                if clip_norm:
                    g.mul_(scale.to(g.dtype))
                g = g.float()
                m.mul_(b1).add_(g * (1 - b1))
                t = g * (1 - b2)
                n.mul_(b2).add_(t.mul_(g))
                upd = (m / bc1).mul_(neg_lr)
                t = torch.div(n, bc2, out=t).sqrt_().add_(eps)
                upd.div_(t)
                del t
                if weight_decay:
                    upd.sub_(step_lr * weight_decay * p.float())
                if p.dtype == torch.float32:
                    p.add_(upd)
                else:
                    p.copy_((p.float() + upd).to(p.dtype))
        state["count"] = count

    return Optimizer(init, update, update_in_place)


def adam(lr: ScalarOrSchedule, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def get(name: str, lr: ScalarOrSchedule, **kw) -> Optimizer:
    return {"sgd": sgd, "rmsprop": rmsprop, "adam": adam,
            "adamw": adamw}[name](lr, **kw)
