"""Optimizers as (init, update) pairs over param trees (port of
`repro/optim/optimizers.py`; optax-style, not `torch.optim`).

`update(grads, state, params) -> (updates, state)` is functional: it
returns new tensors and leaves its inputs alone, so an engine can keep
the previous state (the reference's semantics).  Moments are float32
whatever the params' type.  An optimizer state is a tree of tensors, so
the engine stacks per-client states like parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.nn.module import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable        # params -> state
    update: Callable      # (grads, state, params) -> (updates, state)


def _step0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def sgd(lr: float | Callable, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), {"step": step}
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        ups = tree_map(lambda m: -lr_t * m, mu)
        return ups, {"step": step, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with the reference's defaults (b2 = 0.95).  Weight decay
    applies to matrices only (`ndim >= 2`): call `update` on ONE client's
    tree, as the reference vmaps it, never on a stacked tree, where every
    bias would look like a matrix."""
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "m": tree_map(z, params),
                "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        t = step.float()
        mhat_scale = 1.0 / (1 - torch.pow(b1, t))
        vhat_scale = 1.0 / (1 - torch.pow(b2, t))

        def upd(m_, v_, p):
            u = -lr_t * (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale)
                                              + eps)
            if weight_decay and p.ndim >= 2:   # decay matrices only
                u = u - lr_t * weight_decay * p.float()
            return u

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


adam = adamw  # alias (weight_decay defaults to 0)
