"""Mixture-of-Experts with sort-based capacity dispatch (mixtral-8x7b,
deepseek-v3).

The counterpart of ``repro.models.moe``: a router in f32 scores every
expert (softmax, or for a model with shared experts, deepseek's sigmoid)
and picks the top-k of every token, renormalising their weights;
sort-based dispatch packs each row's assignments into fixed-capacity
expert buffers ``[B,E,C,d]``, the expert FFN is three grouped GEMMs
(``kernels.ops.expert_ffn``: the Hopper kernel for CUDA tensors, with its
backward, its plain version for CPU tensors), and the results are
scattered back with their combine weights.  Assignments past an expert's
capacity are dropped and pass through the residual.  Shared experts are
one SwiGLU MLP of ``n_shared_experts * moe_d_ff``, added to the routed
output.  ``aux_load_balance_loss`` is the reference's auxiliary loss,
which its ``loss_fn`` does not call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import (entry_dims, is_dtensor, local_by_axes,
                                    pspec, shard)
from ..kernels import ops
from .config import ModelConfig
from .layers import adtype, mlp_apply, mlp_defs
from .params import ParamInfo


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    defs = {
        "router": ParamInfo((d, e), "float32", (None, "expert")),
        "wi": ParamInfo((e, d, f), cfg.param_dtype,
                        ("expert", None, "mlp"), fsdp_dim=1),
        "wg": ParamInfo((e, d, f), cfg.param_dtype,
                        ("expert", None, "mlp"), fsdp_dim=1),
        "wo": ParamInfo((e, f, d), cfg.param_dtype,
                        ("expert", "mlp", None), fsdp_dim=2),
    }
    if cfg.n_shared_experts > 0:
        defs["shared"] = mlp_defs(cfg, d_ff=cfg.n_shared_experts * f)
    return defs


def expert_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    c = int(np.ceil(tokens_per_row * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor))
    return max(8, int(np.ceil(c / 8)) * 8)


def _dispatch(e_flat: torch.Tensor, capacity: int, n_experts: int):
    """Per-row dispatch indices, for every row at once.

    e_flat: [B, S*k] expert id per assignment (row-major over (token, k)).
    Returns (order, slot, keep), each [B, S*k]: for each sorted assignment,
    its source assignment index, its slot in the row's [E*C] buffer, and
    whether it fits.  A dropped assignment gets slot ``e*C + C-1``.
    """
    order = torch.argsort(e_flat, dim=1, stable=True)   # jnp.argsort: stable
    se = torch.gather(e_flat, 1, order)
    experts = torch.arange(n_experts, device=e_flat.device)
    group_start = torch.searchsorted(
        se, experts.expand(se.shape[0], n_experts).contiguous())
    pos = (torch.arange(se.shape[1], device=e_flat.device)
           - torch.gather(group_start, 1, se))
    keep = pos < capacity
    slot = se * capacity + pos.clamp(max=capacity - 1)
    return order, slot, keep


def moe_apply(cfg: ModelConfig, p, x):
    """x: [B, S, d] -> [B, S, d] (decode is S = 1)."""
    dt = adtype(cfg)
    w = (p["router"], p["wi"].to(dt), p["wg"].to(dt), p["wo"].to(dt))
    if is_dtensor(x):
        out = _moe_meshed(cfg, x, *w)
    else:
        out = _moe_local(cfg, 0, x, *w)
    if cfg.n_shared_experts > 0:
        out = out + mlp_apply(cfg, p["shared"], x)
    return out


def _moe_meshed(cfg: ModelConfig, x, router, wi, wg, wo):
    """The routed experts under a mesh: the reference's layout.  Each
    device routes its own batch rows (whole, as the vmapped dispatch of
    the reference keeps every row on its device) and runs the expert FFN
    on its shard of the weights: its experts where the experts divide the
    model dim (deepseek's 256), else its slice of F (mixtral's 8 experts
    keep ``expert`` unsharded, and ``wi``/``wg``/``wo`` split over
    ``mlp``).  So no device holds another row's dispatch buffer or another
    device's experts.  Each device's output is its share of the routed
    sum (a partial sum over the mesh dims that split the experts or F),
    reduced by the ``shard`` after it.  One ``local_map``: DTensor would
    gather the scatter's index and buffer whole onto every device."""
    w_axes, o_axes = ("expert", None, "mlp"), ("expert", "mlp", None)
    spec = pspec(*w_axes, shape=tuple(wi.shape))
    mesh = x.device_mesh
    by_expert = entry_dims(spec[0])

    def local(x, router, wi, wg, wo):
        e0 = 0                    # this device's first expert
        for m in by_expert:
            i = mesh.mesh_dim_names.index(m)
            e0 = e0 * mesh.size(i) + mesh.get_local_rank(i)
        return _moe_local(cfg, e0 * wi.shape[0], x, router, wi, wg, wo)

    rows = ("batch", None, None)
    out = local_by_axes(
        local, (x, router, wi, wg, wo),
        [rows, (None, None), w_axes, w_axes, o_axes], [(rows, x.shape)],
        partial=by_expert + entry_dims(spec[2]))
    return shard(out, "batch", None, "embed")


def _moe_local(cfg: ModelConfig, e0: int, x, router, wi, wg, wo):
    """The routed experts on plain tensors: the rows x [b, S, d], the
    whole router, and the experts ``e0 .. e0 + wi.shape[0]`` of
    ``wi``/``wg`` [E_l, d, F_l] and ``wo`` [E_l, F_l, d] (a device's F
    slice, if F is split over a mesh; all of it, with e0 = 0, on one
    device).  Only the assignments to those experts fill the buffer
    [b, E_l·C, d], and the output is their share of the combine."""
    dt = adtype(cfg)
    b, s, d = x.shape
    e, k, el = cfg.n_experts, cfg.top_k, wi.shape[0]
    cap = expert_capacity(cfg, s)

    # Router in f32: deepseek's sigmoid scores with shared experts,
    # mixtral's softmax without.
    logits = x.float() @ router.float()
    scores = torch.sigmoid(logits) if cfg.n_shared_experts > 0 \
        else torch.softmax(logits, dim=-1)
    topw, topi = _top_k(scores, k)                           # [B,S,k]
    topw = (topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)).to(dt)
    order, slot, keep = _dispatch(topi.reshape(b, s * k), cap, e)
    src_tok = order // k                                     # [B, S*k]
    mine = (slot >= e0 * cap) & (slot < (e0 + el) * cap)
    kept = keep & mine

    # Gather tokens into expert buffers [B, E_l*C, d].  JAX scatters every
    # assignment with ``.at[slot].set``, and a dropped one lands, as a zero
    # row, on its expert's last slot C-1, where the CPU keeps the last of
    # duplicate writes: the token kept at rank C-1 of an overflowing expert
    # is overwritten with zeros.  torch's scatter gives duplicates no
    # order, so kept rows go to their (unique) slots and dropped ones to a
    # spare row E_l*C, and then slot C-1 of every expert that overflowed is
    # zeroed, as the reference does.  No boolean indexing: on the card that
    # would wait for the device.  Each row scatters within itself (no
    # global row index).
    spare = el * cap
    local_slot = torch.where(kept, slot - e0 * cap, spare)
    gathered = torch.gather(x, 1, src_tok[..., None].expand(-1, -1, d))
    gathered = gathered * kept[..., None].to(dt)
    buf = x.new_zeros((b, spare + 1, d), dtype=dt).scatter_(
        1, local_slot[..., None].expand(-1, -1, d), gathered)
    overflow = kept.new_zeros((b, spare + 1)).scatter_(
        1, torch.where(mine & ~keep, slot - e0 * cap, spare), True)
    buf = buf[:, :spare].masked_fill(overflow[:, :spare, None], 0)
    buf = buf.reshape(b, el, cap, d)

    # Expert FFN: three grouped GEMMs, SwiGLU in between.
    h = ops.expert_ffn(buf, wi)
    g = ops.expert_ffn(buf, wg)
    y = ops.expert_ffn(F.silu(g) * h, wo).contiguous().reshape(b, spare, d)

    # Scatter back with the combine weights, in the activation dtype.
    w_sorted = torch.gather(topw.reshape(b, s * k), 1, order)
    contrib = torch.gather(
        y, 1, torch.where(kept, local_slot, 0)[..., None].expand(-1, -1, d))
    contrib = contrib * (w_sorted * kept)[..., None].to(dt)
    out = x.new_zeros((b, s, d), dtype=dt)
    return out.scatter_add(1, src_tok[..., None].expand(-1, -1, d), contrib)


def _top_k(scores, k: int):
    """``lax.top_k``: the k largest along the last axis, ties broken by the
    lower index, as a stable descending sort does (``torch.topk`` promises
    no order); the values carry the gradient."""
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    return topw[..., :k], topi[..., :k]


def aux_load_balance_loss(cfg: ModelConfig, x, p) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fraction * probability):
    the reference's, over softmax probabilities for every model."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    _, topi = _top_k(probs, cfg.top_k)
    onehot = F.one_hot(topi, cfg.n_experts).float()
    frac = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    prob = torch.mean(probs, dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * prob)
