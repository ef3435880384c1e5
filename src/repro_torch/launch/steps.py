"""Step builders: the train step (value-and-grad, clip, optimizer) and the
serve step (greedy decode), and the placements of the whole train state.

The counterpart of ``repro.launch.steps``: ``make_train_step``,
``make_serve_step`` and the sharding helpers ``state_shardings``,
``opt_state_structs``, ``batch_shardings`` and ``cache_shardings``, which
give DTensor placements (one tuple a leaf) where the reference gives
``NamedSharding``s.  :func:`refuse_like_reference` keeps the launchers and
captures to what the reference's can run.
"""
from __future__ import annotations

from functools import partial

import torch

from ..distributed.sharding import (is_dtensor, param_pspec, placements,
                                    pspec, shape_structs, shard)
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import ParamInfo, tree_items, tree_map
from ..optim import apply_updates, clip_by_global_norm
from ..optim.optimizers import OptState, Optimizer


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
            partial(_into_stack, stacked, out, t, i))
            for i, x in enumerate(out))
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


def _into_stack(stacked: dict, layers: tuple, param, i: int, x) -> None:
    """Copy layer ``i``'s gradient into its stack, made at the first one
    that arrives (in the backward, not before the forward), and note that
    it arrived.  Under a mesh the stack is laid out as the stacked
    parameter ``param`` (each device its shard), where ``new_zeros`` would
    make it whole on every device."""
    entry = stacked.get(id(layers))
    if entry is None:
        entry = stacked[id(layers)] = (
            torch.zeros_like(param) if is_dtensor(param)
            else x.grad.new_zeros((len(layers), *x.shape)), set())
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
            micro = {k: _microbatches(x, grad_accum)
                     for k, x in batch.items()}
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

        # The norm, the guard's verdict, then the update: on the card as
        # two launches of the fused pass where the optimizer has one and
        # every leaf suits it, else per leaf.
        fused = opt.fused(grads, opt_state, params) if opt.fused else None
        if fused is None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        else:
            gnorm = fused.norm(max_grad_norm)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "action": "ok"}
        if guard is not None:
            metrics["action"] = guard.check(float(loss), float(gnorm))
            if metrics["action"] != "ok":
                return params, opt_state, metrics
        if fused is None:
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        else:
            opt_state = fused.update()
        return params, opt_state, metrics

    return train_step


def _microbatches(x, n: int):
    """``x`` [B, ...] as ``[n, B / n, ...]``: microbatch i is rows
    ``i * B/n ...`` (the reference's split).  A DTensor batch (the dry
    run's, sharded over its rows) takes rows ``i::n`` instead, which keeps
    every microbatch's rows on the devices that hold them; the same rows in
    all, in another grouping."""
    if is_dtensor(x):
        return x.reshape(x.shape[0] // n, n, *x.shape[1:]).transpose(0, 1)
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


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
        # Under a mesh the argmax reads whole rows: the vocab gathered.
        last = shard(logits[:, -1:], "batch", None, None)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
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


# ---------------------------------------------------------------------------
# Placements of the full train state
# ---------------------------------------------------------------------------

def _opt_state_infos(opt_name: str, defs, zero1: bool = True):
    """ParamInfo tree of the optimizer's inner state, in the layout of
    ``optim.optimizers``: AdamW ``{"m", "v"}``, SGDM one tree, Adafactor
    ``{"vr", "vc"}`` for a matrix and ``{"v"}`` otherwise.  Every leaf is
    f32 and keeps its parameter's ``fsdp_dim``, which ZeRO-1 shards even
    without FSDP (Adafactor's factored rows and columns have none)."""
    def promote(info: ParamInfo) -> ParamInfo:
        return ParamInfo(info.shape, "float32", info.axes,
                         fsdp_dim=info.fsdp_dim, init_scale=0.0)

    if opt_name == "adamw":
        return {"m": tree_map(promote, defs), "v": tree_map(promote, defs)}
    if opt_name == "sgdm":
        return tree_map(promote, defs)
    if opt_name == "adafactor":
        def one(info: ParamInfo):
            if len(info.shape) >= 2:
                axes = info.axes or (None,) * len(info.shape)
                return {"vr": ParamInfo(info.shape[:-1], "float32",
                                        axes[:-1], init_scale=0.0),
                        "vc": ParamInfo(info.shape[:-2] + info.shape[-1:],
                                        "float32", axes[:-2] + axes[-1:],
                                        init_scale=0.0)}
            return {"v": ParamInfo(info.shape, "float32", info.axes,
                                   init_scale=0.0)}
        return tree_map(one, defs)
    raise ValueError(opt_name)


def state_shardings(cfg: ModelConfig, mesh, opt_name: str,
                    fsdp: bool = False, zero1: bool = True):
    """``(param placements, OptState(step, inner placements))``: each
    parameter's spec (``param_pspec``), and the optimizer state's with
    ``fsdp_dim`` sharded whenever ``zero1`` (ZeRO-1), on ``mesh``."""
    defs = M.param_defs(cfg)

    def of(info: ParamInfo, force_fsdp: bool):
        return placements(param_pspec(info, mesh=mesh,
                                      fsdp=fsdp or force_fsdp), mesh)

    p_sh = tree_map(lambda i: of(i, False), defs)
    o_sh = tree_map(lambda i: of(i, zero1),
                    _opt_state_infos(opt_name, defs, zero1))
    return p_sh, OptState(step=placements((), mesh), inner=o_sh)


def opt_state_structs(cfg: ModelConfig, opt_name: str, device="meta"):
    """The optimizer state as empty tensors on ``device`` (the dry run's
    stand-ins): the step count and the inner tree."""
    infos = _opt_state_infos(opt_name, M.param_defs(cfg), zero1=True)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    inner=shape_structs(infos, device))


def batch_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{name: (shape, dtype)}`` of a train or prefill batch: the
    reference's ``make_batch_specs``."""
    tok = ((batch, seq_len, cfg.n_codebooks) if cfg.n_codebooks
           else (batch, seq_len))
    specs = {"tokens": (tok, torch.int32)}
    if cfg.cross_attn_dim:
        specs["img_embed"] = ((batch, cfg.cross_attn_tokens,
                               cfg.cross_attn_dim), torch.bfloat16)
    return specs


def batch_shardings(cfg: ModelConfig, mesh, specs: dict) -> dict:
    """Each batch leaf's placements: its first dim over ``batch``."""
    return {k: placements(pspec("batch", *[None] * (len(shape) - 1),
                                mesh=mesh), mesh)
            for k, (shape, _) in specs.items()}


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The KV (MLA latent, recurrent) cache's placements, by its
    ``cache_defs`` axes (no FSDP)."""
    return tree_map(lambda i: placements(
        param_pspec(i, mesh=mesh, fsdp=False), mesh),
        M.cache_defs(cfg, batch, max_len))
