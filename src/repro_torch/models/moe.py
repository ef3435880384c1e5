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

from ..distributed.sharding import (entry_dims, fsdp_enabled, is_dtensor,
                                    local_by_axes, mesh_index, pspec, shard)
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
    gather the scatter's index and buffer whole onto every device.  Where
    the rows are replicated over the dims FSDP splits ``d`` over
    (``long_500k``'s one row), the weights stay split there too
    (:func:`_moe_fsdp`)."""
    w_axes, o_axes = ("expert", None, "mlp"), ("expert", "mlp", None)
    spec = pspec(*w_axes, shape=tuple(wi.shape))
    mesh = x.device_mesh
    by_expert = entry_dims(spec[0])
    by_d = entry_dims(pspec("expert", "fsdp", "mlp",
                            shape=tuple(wi.shape))[1]) \
        if fsdp_enabled() else ()
    names = list(mesh.mesh_dim_names)
    by_rows = {names[m] for m, p in enumerate(x.placements)
               if p.is_shard(0)}
    if by_d and not by_rows & set(by_d):
        return _moe_fsdp(cfg, x, router, wi, wg, wo, by_expert,
                         entry_dims(spec[2]), by_d)

    def local(x, router, wi, wg, wo):
        return _moe_local(cfg, mesh_index(mesh, by_expert) * wi.shape[0], x,
                          router, wi, wg, wo)

    rows = ("batch", None, None)
    out = local_by_axes(
        local, (x, router, wi, wg, wo),
        [rows, (None, None), w_axes, w_axes, o_axes], [(rows, x.shape)],
        partial=by_expert + entry_dims(spec[2]))
    return shard(out, "batch", None, "embed")


def _moe_fsdp(cfg: ModelConfig, x, router, wi, wg, wo, by_expert, by_f,
              by_d):
    """The routed experts where the rows are replicated over the mesh dims
    ``by_d`` that FSDP splits ``d`` over: the weights keep their FSDP
    shards (``wi``/``wg`` [E_l, d_l, F_l], ``wo`` [E_l, F_l, d_l]), as the
    reference's partitioner keeps them, instead of being gathered whole
    onto every device.  Each device routes the rows whole (they are
    replicated), contracts its ``d`` slice of the dispatch buffer with its
    shard of ``wi`` and ``wg`` (partial sums over ``by_d``, reduced before
    the SwiGLU: [E_l, C, F_l] a row), and produces its ``d`` slice of the
    output through ``wo``.  Two ``local_map`` calls; the second routes the
    rows again (a [d, E] product a token) rather than take the routing
    through DTensor."""
    mesh = x.device_mesh
    rows = ("batch", None, None)
    w_in, w_out = ("expert", "fsdp", "mlp"), ("expert", "mlp", "fsdp")
    hidden = ("batch", "expert", None, "mlp")
    b, s, _ = x.shape
    first = mesh_index(mesh, by_expert)   # this device's share of the experts

    def up(x, router, wi, wg):
        route = _route(cfg, first * wi.shape[0], wi.shape[0], x, router)
        d0 = mesh_index(mesh, by_d) * wi.shape[1]
        buf = _buffer(x[..., d0:d0 + wi.shape[1]], route)
        return ops.expert_ffn(buf, wi), ops.expert_ffn(buf, wg)

    hg_shape = (b, cfg.n_experts, expert_capacity(cfg, s), wi.shape[2])
    h, g = local_by_axes(up, (x, router, wi, wg),
                         [rows, (None, None), w_in, w_in],
                         [(hidden, hg_shape)] * 2, partial=by_d)

    def down(x, router, h, g, wo):
        route = _route(cfg, first * wo.shape[0], wo.shape[0], x, router)
        return _combine(ops.expert_ffn(F.silu(g) * h, wo), route)

    out = local_by_axes(down, (x, router, h, g, wo),
                        [rows, (None, None), hidden, hidden, w_out],
                        [(("batch", None, "fsdp"), x.shape)],
                        partial=by_expert + by_f)
    return shard(out, "batch", None, "embed")


def _moe_local(cfg: ModelConfig, e0: int, x, router, wi, wg, wo):
    """The routed experts on plain tensors: the rows x [b, S, d], the
    whole router, and the experts ``e0 .. e0 + wi.shape[0]`` of
    ``wi``/``wg`` [E_l, d, F_l] and ``wo`` [E_l, F_l, d] (a device's F
    slice, if F is split over a mesh; all of it, with e0 = 0, on one
    device).  Only the assignments to those experts fill the buffer
    [b, E_l·C, d], and the output is their share of the combine."""
    route = _route(cfg, e0, wi.shape[0], x, router)
    buf = _buffer(x, route)
    # Expert FFN: three grouped GEMMs, SwiGLU in between.
    h = ops.expert_ffn(buf, wi)
    g = ops.expert_ffn(buf, wg)
    return _combine(ops.expert_ffn(F.silu(g) * h, wo), route)


def _route(cfg: ModelConfig, e0: int, el: int, x, router) -> dict:
    """Route the rows x [b, S, d] and place the assignments to experts
    ``e0 .. e0 + el``: the source token of each sorted assignment, its
    slot in the local buffer (a spare row ``el·C`` where it is dropped or
    another device's), whether it is kept and its combine weight, and
    which slots overflowed."""
    dt = adtype(cfg)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = expert_capacity(cfg, s)

    # Router in f32: deepseek's sigmoid scores with shared experts,
    # mixtral's softmax without.
    logits = x.float() @ router.float()
    scores = torch.sigmoid(logits) if cfg.n_shared_experts > 0 \
        else torch.softmax(logits, dim=-1)
    topw, topi = _top_k(scores, k)                           # [B,S,k]
    topw = (topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)).to(dt)
    order, slot, keep = _dispatch(topi.reshape(b, s * k), cap, e)
    mine = (slot >= e0 * cap) & (slot < (e0 + el) * cap)
    kept = keep & mine
    # JAX scatters every assignment with ``.at[slot].set``, and a dropped
    # one lands, as a zero row, on its expert's last slot C-1, where the
    # CPU keeps the last of duplicate writes: the token kept at rank C-1 of
    # an overflowing expert is overwritten with zeros.  torch's scatter
    # gives duplicates no order, so kept rows go to their (unique) slots
    # and dropped ones to a spare row E_l*C, and then slot C-1 of every
    # expert that overflowed is zeroed, as the reference does.  No boolean
    # indexing: on the card that would wait for the device.  Each row
    # scatters within itself (no global row index).
    spare = el * cap
    overflow = kept.new_zeros((b, spare + 1)).scatter_(
        1, torch.where(mine & ~keep, slot - e0 * cap, spare), True)
    return {"src_tok": order // k, "kept": kept, "el": el, "cap": cap,
            "rows": s,
            "slot": torch.where(kept, slot - e0 * cap, spare),
            "overflow": overflow[:, :spare, None],
            "w": torch.gather(topw.reshape(b, s * k), 1, order)}


def _buffer(x, route):
    """The expert buffers [b, E_l, C, d] of rows x [b, S, d] (``d`` may be
    a device's slice of it), by :func:`_route`'s placement."""
    b, _, d = x.shape
    el, cap, src = route["el"], route["cap"], route["src_tok"]
    spare = el * cap
    gathered = torch.gather(x, 1, src[..., None].expand(-1, -1, d))
    gathered = gathered * route["kept"][..., None].to(x.dtype)
    buf = x.new_zeros((b, spare + 1, d)).scatter_(
        1, route["slot"][..., None].expand(-1, -1, d), gathered)
    buf = buf[:, :spare].masked_fill(route["overflow"], 0)
    return buf.reshape(b, el, cap, d)


def _combine(y, route):
    """The experts' outputs y [b, E_l, C, d] scattered back to the rows
    with their combine weights, in y's dtype: [b, S, d]."""
    b, el, cap, d = y.shape
    y = y.contiguous().reshape(b, el * cap, d)
    src, kept = route["src_tok"], route["kept"]
    contrib = torch.gather(
        y, 1, torch.where(kept, route["slot"], 0)[..., None].expand(
            -1, -1, d))
    contrib = contrib * (route["w"] * kept)[..., None].to(y.dtype)
    out = y.new_zeros((b, route["rows"], d))
    return out.scatter_add(1, src[..., None].expand(-1, -1, d), contrib)


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
