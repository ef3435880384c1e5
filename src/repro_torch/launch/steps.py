"""Step builders: the train step (value-and-grad, clip, optimizer) and the
serve step (greedy decode).

The counterpart of ``repro.launch.steps``'s ``make_train_step`` and
``make_serve_step``; the sharding helpers have no counterpart on one card.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items, tree_map
from ..optim import apply_updates, clip_by_global_norm
from ..optim.optimizers import Optimizer


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``(loss, grads)`` of ``M.loss_fn``: ``jax.value_and_grad``'s
    counterpart.  ``grads`` has the structure and dtypes of ``params``.

    Each stacked ``groups`` leaf is split into one autograd leaf per group
    (``forward`` indexes a tuple as it indexes the stack), and the groups'
    gradients are stacked once at the end: differentiated through ``t[g]``,
    every group would add a zero-padded gradient of the whole stack.
    """
    def split(t):
        return tuple(x.requires_grad_() for x in t.detach().unbind(0))

    leaves = {k: tree_map(split if k == "groups" else
                          (lambda t: t.detach().requires_grad_()), v)
              for k, v in params.items()}
    flat = [t for _, leaf in tree_items(leaves)
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]
    with torch.enable_grad():
        loss = M.loss_fn(cfg, leaves, batch)
        grads = iter(torch.autograd.grad(loss, flat))

    def take(leaf):
        if isinstance(leaf, tuple):
            return torch.stack([next(grads) for _ in leaf])
        return next(grads)

    return loss.detach(), tree_map(take, leaves)


def make_train_step(cfg: ModelConfig, opt: Optimizer, grad_accum: int = 1,
                    max_grad_norm: float = 1.0, guard=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  Parameters and optimizer state are updated in place.

    ``guard`` (a ``distributed.monitor.DivergenceGuard``), if given, checks
    each step's loss and gradient norm before the update, and
    ``metrics["action"]`` is its verdict: on any but ``"ok"`` the
    parameters and optimizer state are left as they were, as the
    reference's loop drops the new state it returned (an update made in
    place cannot be dropped afterwards).  Without a guard the action is
    ``"ok"``.

    With ``grad_accum > 1`` the batch splits into that many microbatches
    along its first axis; losses and f32 gradients are summed over them and
    averaged, as the reference's scan does.
    """

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            micro = {k: x.reshape(grad_accum, x.shape[0] // grad_accum,
                                  *x.shape[1:]) for k, x in batch.items()}
            loss_sum = grads = None
            for i in range(grad_accum):
                l, g = loss_and_grads(cfg, params,
                                      {k: x[i] for k, x in micro.items()})
                g32 = tree_map(lambda t: t.float(), g)
                loss_sum = l if loss_sum is None else loss_sum + l
                grads = g32 if grads is None else tree_map(
                    torch.add, grads, g32)
            loss = loss_sum / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch)

        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "action": "ok"}
        if guard is not None:
            metrics["action"] = guard.check(float(loss), float(gnorm))
            if metrics["action"] != "ok":
                return params, opt_state, metrics
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode step with greedy argmax over the last position.
    ``pos`` is one shared position clock (a scalar, a Python int too) or a
    ``[B]`` vector of per-slot clocks."""

    def serve_step(params, cache, token, pos):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        logits, cache = M.decode_step(cfg, params, token, cache, pos)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step
