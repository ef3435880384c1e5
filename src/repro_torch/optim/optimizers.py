"""AdamW, its schedule and gradient clipping over dict trees of tensors.

The counterpart of ``repro.optim.optimizers``.  Scalars (the learning rate
at a step, the bias corrections) are computed in numpy float32, as JAX
computes them in f32; tensor arithmetic follows the reference's order.  To
hold one copy of the state at full width, the update writes the moments and
``apply_updates`` writes the parameters in place (JAX returns new trees and
donates the old ones).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.params import tree_items, tree_map


class OptState(NamedTuple):
    step: int
    inner: Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor * peak_lr``
    at ``total``; ``lr(step)`` returns the f32 value as a Python float."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        warm = f32(peak_lr) * s / f32(max(warmup, 1))
        t = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                    f32(0.0), f32(1.0))
        cos = f32(floor * peak_lr) + f32((1 - floor) * peak_lr * 0.5) * (
            f32(1) + np.cos(f32(np.pi) * t))
        return float(warm if s < warmup else cos)
    return lr


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``; returns
    ``(clipped, norm)`` with the norm as an f32 0-dim tensor."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for _, g in tree_items(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    """AdamW with f32 moments ``{"m": tree, "v": tree}``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return OptState(0, {"m": z, "v": tree_map(torch.clone, z)})

    def update(grads, state, params):
        step = state.step + 1
        lr_t = float(np.float32(lr_fn(step)))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def upd(g, m, v, p):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        updates = tree_map(upd, grads, state.inner["m"], state.inner["v"],
                           params)
        return updates, OptState(step, state.inner)

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``p + u`` for every leaf, written into ``params``; returns it."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
