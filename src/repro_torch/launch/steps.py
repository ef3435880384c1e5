"""Step builders: the train step (value-and-grad, clip, optimizer) and the
serve step (greedy decode).

The counterpart of ``repro.launch.steps``'s ``make_train_step`` and
``make_serve_step``; the sharding helpers have no counterpart on one card.
:func:`refuse_like_reference` keeps the launchers and captures to what the
reference's can run.
"""
from __future__ import annotations

from functools import partial

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_items, tree_map
from ..optim import apply_updates, clip_by_global_norm
from ..optim.optimizers import Optimizer


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``(loss, grads)`` of ``M.loss_fn``: ``jax.value_and_grad``'s
    counterpart.  ``grads`` has the structure and dtypes of ``params``;
    ``batch`` holds ``tokens`` and, for a model with ``cross`` blocks,
    ``img_embed`` (an input: it gets no gradient).

    Each stacked leaf (``M.STACKS``: ``dense``, ``groups``) is split into
    one autograd leaf per layer (``forward`` indexes a tuple as it indexes
    the stack): differentiated through ``t[g]``, every layer would add a
    zero-padded gradient of the whole stack.  As the backward produces a
    layer's gradient, a hook copies it into that leaf's stacked gradient
    and drops it, as the reference's scan writes each slice as it goes; so
    no layer's gradient outlives its copy, and none is stacked at the end.
    """
    stacked, hooks = {}, []

    def split(t):
        out = tuple(x.requires_grad_() for x in t.detach().unbind(0))
        hooks.extend(x.register_post_accumulate_grad_hook(
            partial(_into_stack, stacked, out, i)) for i, x in enumerate(out))
        return out

    leaves = {k: tree_map(split if k in M.STACKS else
                          (lambda t: t.detach().requires_grad_()), v)
              for k, v in params.items()}
    try:
        with torch.enable_grad():
            loss = M.loss_fn(cfg, leaves, batch)
            loss.backward()
    finally:      # each hook refers to its own leaf: no cycles left
        for h in hooks:
            h.remove()
    for path, leaf in tree_items(leaves):
        # ``autograd.grad``'s refusal of a leaf the loss does not reach
        if isinstance(leaf, tuple):
            seen = stacked.get(id(leaf), (None, set()))[1]
            missing = [i for i in range(len(leaf)) if i not in seen]
            what = f"{path} (layers {missing})"
        else:
            missing, what = leaf.grad is None, path
        if missing:
            raise RuntimeError(f"loss_and_grads: no gradient reached {what}")

    def take(leaf):
        return stacked[id(leaf)][0] if isinstance(leaf, tuple) else leaf.grad

    return loss.detach(), tree_map(take, leaves)


def _into_stack(stacked: dict, layers: tuple, i: int, x) -> None:
    """Copy layer ``i``'s gradient into its stack, made at the first one
    that arrives (in the backward, not before the forward), and note that
    it arrived."""
    entry = stacked.get(id(layers))
    if entry is None:
        entry = stacked[id(layers)] = (
            x.grad.new_zeros((len(layers), *x.shape)), set())
    entry[0][i].copy_(x.grad)
    entry[1].add(i)
    x.grad = None


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
    """One-token decode step with greedy argmax over the vocabulary at the
    last position: ``[B,1]`` next tokens, ``[B,1,K]`` for a codebook model.
    ``pos`` is one shared position clock (a scalar, a Python int too) or a
    ``[B]`` vector of per-slot clocks; ``img_embed`` the image a model with
    ``cross`` blocks attends to."""

    def serve_step(params, cache, token, pos, img_embed=None):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        logits, cache = M.decode_step(cfg, params, token, cache, pos,
                                      img_embed=img_embed)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


def refuse_like_reference(cfg: ModelConfig, surface: str) -> None:
    """Raise ``NotImplementedError`` where the reference's ``surface`` (its
    ``train`` or ``serve`` launcher, or its ``train capture`` or ``serve
    capture``) fails on ``cfg``, naming that failure; the port's model runs
    both cases, its launchers and captures do what the reference's do.

    - A model with ``cross`` blocks (llama-3.2-vision): no surface passes
      ``img_embed``, so the reference's cross blocks project the text
      stream through the ``cross_attn_dim``-wide ``wk`` and its einsum
      fails ("Size of label 'd' ... does not match").
    - A codebook model (musicgen) in the serve launcher: its token buffer
      is ``[slots, 1]``, whose codebook embedding is a rank-2 activation
      that the reference's sharding constraint refuses ("only valid for
      values of rank at least 3").
    """
    if M.has_cross(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the reference's {surface} passes no img_embed, so "
            f"its cross blocks project the {cfg.d_model}-wide text stream "
            f"through the {cfg.cross_attn_dim}-wide wk and fail (Size of "
            f"label 'd' ... does not match); call models.model.forward, "
            f"loss_fn or decode_step with img_embed instead")
    if cfg.n_codebooks and surface == "serve launcher":
        raise NotImplementedError(
            f"{cfg.name}: the reference's serve launcher keeps a [slots, 1] "
            f"token buffer, not [slots, 1, {cfg.n_codebooks}]; its codebook "
            f"embedding of it is rank 2, which its sharding constraint "
            f"refuses (only valid for values of rank at least 3); call "
            f"make_serve_step with [slots, 1, K] tokens instead")
