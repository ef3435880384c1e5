"""Mixture-of-Experts with sort-based capacity dispatch (mixtral-8x7b).

The counterpart of ``repro.models.moe``: a softmax router in f32 picks the
top-k experts of every token, sort-based dispatch packs each row's
assignments into fixed-capacity expert buffers ``[B,E,C,d]``, the expert
FFN is three grouped GEMMs (``kernels.ops.expert_ffn``: the Hopper kernel
for CUDA tensors, its plain version for CPU tensors), and the results are
scattered back with their combine weights.  Assignments past an expert's
capacity are dropped and pass through the residual.  Deepseek's shared
experts and sigmoid router are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import adtype
from .params import ParamInfo


def _check_routed_only(cfg: ModelConfig) -> None:
    if cfg.n_shared_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: shared experts (n_shared_experts="
            f"{cfg.n_shared_experts}) are not ported yet")


def moe_defs(cfg: ModelConfig) -> dict:
    _check_routed_only(cfg)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {
        "router": ParamInfo((d, e), "float32", (None, "expert")),
        "wi": ParamInfo((e, d, f), cfg.param_dtype,
                        ("expert", None, "mlp"), fsdp_dim=1),
        "wg": ParamInfo((e, d, f), cfg.param_dtype,
                        ("expert", None, "mlp"), fsdp_dim=1),
        "wo": ParamInfo((e, f, d), cfg.param_dtype,
                        ("expert", "mlp", None), fsdp_dim=2),
    }


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
    _check_routed_only(cfg)
    dt = adtype(cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = expert_capacity(cfg, s)

    # Router in f32.  lax.top_k breaks ties by the lower index: a stable
    # descending sort does the same (torch.topk promises no order).
    scores = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]                # [B,S,k]
    topw = (topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)).to(dt)

    e_flat = topi.reshape(b, s * k)
    w_flat = topw.reshape(b, s * k)
    order, slot, keep = _dispatch(e_flat, cap, e)
    src_tok = order // k                                     # [B, S*k]

    # Gather tokens into expert buffers [B, E*C, d].  JAX scatters every
    # assignment with ``.at[slot].set``, and a dropped one lands, as a zero
    # row, on its expert's last slot C-1, where the CPU keeps the last of
    # duplicate writes: the token kept at rank C-1 of an overflowing expert
    # is overwritten with zeros.  torch's index_put_ gives duplicates no
    # order, so kept rows go to their (unique) slots and dropped ones to a
    # spare row E*C, and then slot C-1 of every expert that overflowed is
    # zeroed, as the reference does.  No boolean indexing: on the card that
    # would wait for the device.
    gathered = torch.gather(x, 1, src_tok[..., None].expand(-1, -1, d))
    gathered = gathered * keep[..., None].to(dt)
    rows = torch.arange(b, device=x.device)[:, None]
    spare = e * cap
    buf = torch.zeros(b, spare + 1, d, dtype=dt, device=x.device)
    buf[rows, torch.where(keep, slot, spare)] = gathered
    overflow = torch.zeros(b, spare + 1, dtype=torch.bool, device=x.device)
    overflow[rows, torch.where(keep, spare, slot)] = True
    buf = buf[:, :spare].masked_fill(overflow[:, :spare, None], 0)
    buf = buf.reshape(b, e, cap, d)

    # Expert FFN: three grouped GEMMs, SwiGLU in between.
    h = ops.expert_ffn(buf, p["wi"].to(dt))
    g = ops.expert_ffn(buf, p["wg"].to(dt))
    y = ops.expert_ffn(F.silu(g) * h, p["wo"].to(dt)).reshape(b, spare, d)

    # Scatter back with the combine weights, in the activation dtype.
    w_sorted = torch.gather(w_flat, 1, order)
    contrib = torch.gather(y, 1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * (w_sorted * keep)[..., None].to(dt)
    out = torch.zeros(b, s, d, dtype=dt, device=x.device)
    return out.scatter_add_(1, src_tok[..., None].expand(-1, -1, d), contrib)
