"""Decoupled AdamW with global-norm clipping and a cosine schedule (the
port of ``repro.optim.adamw``): plain functions over the parameter tree,
not ``torch.optim``.

Moments are fp32.  The arithmetic is the reference's, op for op, but the
state is updated IN PLACE, one leaf at a time: ``update`` writes the new
moments into the state's tensors, and ``step`` also adds each leaf's
update into its parameter (or its fp32 master copy) before it computes
the next leaf's, so a step holds one leaf's temporaries at a time beside
the parameters, gradients and moments (a full-width model has room for
little more).  The reference rebuilt every tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.params import (tree_flatten, tree_leaves, tree_map,
                                       tree_unflatten)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    """-> lr(step): linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; fp32, on step's device."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr


def _is_leaf(x) -> bool:
    return torch.is_tensor(x)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable = staticmethod(lambda step: 1e-3)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # mixed precision: the model's params in the compute dtype, the fp32
    # master copy in the optimizer state
    master_fp32: bool = False

    def init(self, params):
        device = tree_leaves(params, _is_leaf)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        state = {"mu": tree_map(zeros, params, _is_leaf),
                 "nu": tree_map(zeros, params, _is_leaf),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=device)}
        if self.master_fp32:
            state["master"] = tree_map(
                lambda p: p.detach().float().clone(), params, _is_leaf)
        return state

    def _prologue(self, grads, count):
        """-> (count + 1, grad norm, (clip scale or None, c1, c2, lr))."""
        count = count + 1
        if self.clip_norm:
            gnorm = torch.sqrt(sum((g.float() * g.float()).sum()
                                   for g in tree_leaves(grads, _is_leaf)))
            scale = torch.clamp(self.clip_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            gnorm = torch.zeros((), device=count.device)
            scale = None
        c1 = 1 - self.b1 ** count.float()
        c2 = 1 - self.b2 ** count.float()
        return count, gnorm, (scale, c1, c2, self.learning_rate(count))

    def _leaf(self, g, m, v, p, scale, c1, c2, lr):
        """Update one leaf's moments in place; -> its update, p's dtype."""
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(self.b1).add_((1 - self.b1) * g)
        v.mul_(self.b2).add_((1 - self.b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        step = step + self.weight_decay * p.float()
        return (-lr * step).to(p.dtype)

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (updates, new_state, grad_norm); the state's moments are
        updated in place and returned in ``new_state``."""
        count, gnorm, coef = self._prologue(grads, state["count"])
        updates = [self._leaf(g, m, v, p, *coef) for g, m, v, p in zip(
            tree_leaves(grads, _is_leaf), tree_leaves(state["mu"], _is_leaf),
            tree_leaves(state["nu"], _is_leaf),
            tree_leaves(params, _is_leaf))]
        return (tree_unflatten(tree_flatten(params, _is_leaf)[1], updates),
                {"mu": state["mu"], "nu": state["nu"], "count": count},
                gnorm)

    def apply(self, params, updates):
        return tree_map(lambda p, u: p + u, params, _is_leaf, updates)

    @torch.no_grad()
    def step(self, grads, state, params):
        """-> (params, new_state, grad_norm), all updated in place.  In
        master_fp32 mode the update lands on the fp32 master copy and the
        params are re-derived from it."""
        target = state["master"] if self.master_fp32 else params
        count, gnorm, coef = self._prologue(grads, state["count"])
        for g, m, v, t in zip(tree_leaves(grads, _is_leaf),
                              tree_leaves(state["mu"], _is_leaf),
                              tree_leaves(state["nu"], _is_leaf),
                              tree_leaves(target, _is_leaf)):
            t.add_(self._leaf(g, m, v, t, *coef))
        new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
        if self.master_fp32:
            for p, t in zip(tree_leaves(params, _is_leaf),
                            tree_leaves(target, _is_leaf)):
                p.copy_(t)
            new_state["master"] = target
        return params, new_state, gnorm

