"""AdamW, Adafactor and SGD with momentum, the cosine schedule and gradient
clipping over dict trees of tensors.

The counterpart of ``repro.optim.optimizers``.  Scalars (the learning rate
at a step, the bias corrections) are computed in numpy float32, as JAX
computes them in f32; tensor arithmetic follows the reference's order.  To
hold one copy of the state at full width, the update writes the moments and
``apply_updates`` writes the parameters in place (JAX returns new trees and
donates the old ones).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..distributed.sharding import is_dtensor
from ..kernels import fused_adamw as fa
from ..models.params import tree_items, tree_map


class OptState(NamedTuple):
    step: int
    inner: Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]
    # ``fused(grads, state, params)``: the step's clip and update as one
    # pass on the card (:class:`FusedStep`), or None where the tree takes
    # the per-leaf path (``clip_by_global_norm``, ``update``,
    # ``apply_updates``).  AdamW has one; the others are per-leaf only.
    fused: Optional[Callable[[Any, OptState, Any],
                             Optional["FusedStep"]]] = None


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
    """AdamW with f32 moments ``{"m": tree, "v": tree}``.  On the card a
    tree whose every leaf ``kernels.fused_adamw.takes`` is clipped and
    updated by the fused pass (:attr:`Optimizer.fused`), with the same
    arithmetic as ``update``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    table = fa.LeafTable()

    def scalars(step: int) -> tuple[float, float, float]:
        """The step's learning rate and bias corrections, f32 values."""
        return (float(np.float32(lr_fn(step))),
                float(np.float32(1) - np.float32(b1) ** np.float32(step)),
                float(np.float32(1) - np.float32(b2) ** np.float32(step)))

    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return OptState(0, {"m": z, "v": tree_map(torch.clone, z)})

    def update(grads, state, params):
        step = state.step + 1
        lr_t, bc1, bc2 = scalars(step)

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

    def fused(grads, state, params):
        leaves = [(p, g, m, v) for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_items(params), tree_items(grads),
            tree_items(state.inner["m"]), tree_items(state.inner["v"]))]
        if all(fa.takes(*q) for q in leaves):
            lr_t, bc1, bc2 = scalars(state.step + 1)
            return FusedStep(table.bind(leaves), state, dict(
                lr_t=lr_t, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                bc1=bc1, bc2=bc2))
        fa.fused_adamw.fallback_leaves += sum(
            1 for q in leaves if q[0].device.type == "cuda")
        return None

    return Optimizer(init, update, fused)


class FusedStep:
    """One step of the fused pass (``kernels/fused_adamw.py``), in two
    launches with the divergence guard's verdict between them: :meth:`norm`
    computes the gradients' global norm and the clip scale on the card,
    :meth:`update` clips and updates every leaf in place.  Until
    :meth:`update`, parameters and state are as they were."""

    def __init__(self, table: "fa.LeafTable", state: OptState, hyper: dict):
        self.table, self.state, self.hyper = table, state, hyper
        self.scale = None

    def norm(self, max_norm: float) -> torch.Tensor:
        """The global norm (an f32 0-dim tensor on the card)."""
        out = fa.fused_norm(self.table, max_norm)
        self.scale = out[1]
        return out[0]

    def update(self) -> OptState:
        """Clip and update every leaf in place; the state after the step."""
        fa.fused_adamw(self.table, self.scale, **self.hyper)
        return OptState(self.state.step + 1, self.state.inner)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory ~ O(n+m) per matrix)
# ---------------------------------------------------------------------------

def _laid_as(x, like):
    """``x`` (broadcast against ``like``) as it is without a mesh; under
    one, sharded as ``like`` on every dim where it is full size, so that
    their product runs on each device's shard (DTensor would broadcast a
    replicated factor whole: Adafactor's row-by-column product at a leaf's
    full size on every device)."""
    if not is_dtensor(like):
        return x
    from torch.distributed.tensor import Replicate, Shard
    off = like.dim() - x.dim()
    return x.redistribute(x.device_mesh, [
        Shard(p.dim - off) if p.is_shard() and p.dim >= off
        and x.shape[p.dim - off] == like.shape[p.dim] else Replicate()
        for p in like.placements])


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """Adafactor: a leaf of two or more dims keeps f32 row and column means
    of ``g^2 + eps`` over its last two dims (``vr`` = shape[:-1], ``vc`` =
    shape[:-2] + shape[-1:], stacked leaves included); others keep ``v``.
    The decay is ``1 - t^-decay``; each leaf's update is clipped to RMS
    ``clip_threshold``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def one(p):
            z = partial(torch.zeros, dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return OptState(0, tree_map(one, params))

    def update(grads, state, params):
        step = state.step + 1
        beta = float(np.float32(1) - np.float32(step) ** np.float32(-decay))
        lr_t = float(np.float32(lr_fn(step)))

        def one(g, s, p):
            if isinstance(g, dict):      # a subtree; s holds per-leaf dicts
                return {k: one(g[k], s[k], p[k]) for k in sorted(g)}
            g32 = g.float()
            g2 = g32 * g32 + eps
            if p.dim() >= 2:
                s["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
                s["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
                rfac = (s["vr"] / s["vr"].mean(-1, keepdim=True))[..., None]
                u = g32 * torch.rsqrt(_laid_as(rfac, g32) * _laid_as(
                    s["vc"][..., None, :], g32) + eps)
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g32 * torch.rsqrt(s["v"] + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return one(grads, state.inner, params), OptState(step, state.inner)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------

def sgdm(lr=1e-2, momentum=0.9) -> Optimizer:
    """SGD with f32 momentum ``m = momentum * m + g`` and update
    ``-lr * m``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(0, tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = float(np.float32(lr_fn(step)))

        def upd(g, m, p):
            m.mul_(momentum).add_(g.float())
            return (-lr_t * m).to(p.dtype)

        updates = tree_map(upd, grads, state.inner, params)
        return updates, OptState(step, state.inner)

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](**kw)


def apply_updates(params, updates):
    """``p + u`` for every leaf, written into ``params``; returns it."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
