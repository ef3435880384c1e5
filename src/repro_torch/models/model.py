"""Model assembly: stacked layer groups, full-sequence forward, decode step.

The counterpart of ``repro.models.model`` for homogeneous stacks of
``attn`` (qwen2) or sliding-window ``attn_local`` (mixtral) blocks, each
with a SwiGLU MLP or a routed MoE FFN, and tied or untied embeddings; not
yet MLA, shared experts, mixed patterns, cross attention or codebooks.
Parameters keep the JAX tree's layout and key paths (``embed.tokens``,
``groups.slot0.attn.wq``, ...): each leaf of ``groups`` is stacked
``[n_groups, ...]``, and the JAX package's ``lax.scan`` over groups becomes
a Python loop over that leading axis.  Decode keeps per-slot position
clocks; a windowed layer's KV cache is a ring buffer.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import layers as L
from . import moe as MOE
from .config import ModelConfig
from .params import TORCH_DTYPES, ParamInfo, tree_map


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "pattern": cfg.pattern not in (("attn",), ("attn_local",)),
        "tail": bool(cfg.tail), "mla": cfg.mla,
        "shared experts": cfg.n_shared_experts > 0,
        "n_dense_layers": cfg.n_dense_layers,
        "n_codebooks": cfg.n_codebooks, "logit_softcap": cfg.logit_softcap,
        "cross_attn": cfg.cross_attn_tokens > 0,
        "mlp_act": cfg.mlp_act != "silu",
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (the port runs "
            f"homogeneous attn or attn_local stacks with SwiGLU or routed "
            f"MoE FFNs)")


def _block_defs(cfg: ModelConfig, kind: str, moe_layer: bool) -> dict:
    return {"norm1": L.rmsnorm_defs(cfg), "norm2": L.rmsnorm_defs(cfg),
            "attn": L.attention_defs(cfg),
            "ffn": MOE.moe_defs(cfg) if moe_layer else L.mlp_defs(cfg)}


def _stack_info(info: ParamInfo, n: int) -> ParamInfo:
    return ParamInfo((n, *info.shape), info.dtype,
                     (None, *(info.axes or (None,) * len(info.shape))),
                     fsdp_dim=None if info.fsdp_dim is None
                     else info.fsdp_dim + 1,
                     init_scale=info.init_scale)


def _stack_tree(tree, n: int):
    return tree_map(lambda i: _stack_info(i, n), tree)


def param_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    group = {f"slot{i}": _block_defs(cfg, kind, moe_layer=cfg.moe)
             for i, kind in enumerate(cfg.pattern)}
    return {"embed": L.embed_defs(cfg),
            "groups": _stack_tree(group, cfg.n_groups),
            "final_norm": L.rmsnorm_defs(cfg)}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Any:
    """Random parameters, drawn leaf by leaf in sorted key order from
    ``generator`` and made on its device.

    The scale rule is the JAX package's: ``init_scale == 0.02`` means
    ``1/sqrt(shape[-1])``, and zero-scale leaves (norm scales, biases) are
    zeros.  The draws differ from ``jax.random``'s, so tests carry JAX
    parameters across with ``convert.params_from_jax`` instead.
    """
    def one(info: ParamInfo):
        dtype = TORCH_DTYPES[info.dtype]
        if info.init_scale == 0.0:
            return torch.zeros(info.shape, dtype=dtype,
                               device=generator.device)
        fan = info.shape[-1] if len(info.shape) else 1
        scale = info.init_scale if info.init_scale != 0.02 \
            else 1.0 / np.sqrt(max(fan, 1))
        x = torch.randn(info.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (x * scale).to(dtype)

    return tree_map(one, param_defs(cfg))


def prepare_params(cfg: ModelConfig, params) -> Any:
    """Cast, once at load, every leaf that the layers cast to ``cfg.dtype``
    at each use (the JAX package casts at every use; the cast is
    deterministic, so doing it once gives the same numbers).  Norm scales
    and the MoE router stay in their own dtype: both are read in float32."""
    dt = L.adtype(cfg)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else v if k in ("scale", "router") else v.to(dt)
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def block_apply(cfg: ModelConfig, kind: str, p, x, *, positions,
                moe_layer: bool, cache=None):
    """Pre-norm residual attention block; returns (x, new_cache)."""
    h = L.rmsnorm_apply(cfg, p["norm1"], x)
    window = cfg.window if kind == "attn_local" else 0
    attn_cache = None if cache is None else cache.get("attn")
    a, c2 = L.attention_apply(cfg, p["attn"], h, positions=positions,
                              window=window, cache=attn_cache)
    x = x + a
    h2 = L.rmsnorm_apply(cfg, p["norm2"], x)
    ffn = MOE.moe_apply if moe_layer else L.mlp_apply
    x = x + ffn(cfg, p["ffn"], h2)
    return x, (None if c2 is None else {"attn": c2})


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def forward(cfg: ModelConfig, params, tokens):
    """Full-sequence forward -> logits.  tokens: [B,S] int."""
    x = L.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for g in range(cfg.n_groups):
        slot_params = _group(params["groups"], g)
        for i, kind in enumerate(cfg.pattern):
            x, _ = block_apply(cfg, kind, slot_params[f"slot{i}"], x,
                               positions=positions, moe_layer=cfg.moe)
    x = L.rmsnorm_apply(cfg, params["final_norm"], x)
    return L.unembed_apply(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# Decode (serve)
# ---------------------------------------------------------------------------

def _block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                      max_len: int) -> dict:
    window = cfg.window if kind == "attn_local" else 0
    return {"attn": L.attn_cache_defs(cfg, batch, max_len, window)}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    _check_supported(cfg)
    group = {f"slot{i}": _block_cache_defs(cfg, kind, batch, max_len)
             for i, kind in enumerate(cfg.pattern)}
    return {"groups": _stack_tree(group, cfg.n_groups)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str):
    return tree_map(
        lambda i: torch.zeros(i.shape, dtype=TORCH_DTYPES[i.dtype],
                              device=device),
        cache_defs(cfg, batch, max_len))


def decode_step(cfg: ModelConfig, params, token, cache, pos):
    """One-token decode: token [B,1] at per-slot positions pos [B].

    Returns (logits, cache).  Continuous batching: each slot's request sits
    at its own position.  The cache is updated in place and returned.
    """
    x = L.embed_apply(cfg, params["embed"], token)
    positions = pos[:, None]    # rope wants [B, S] with S = 1
    for g in range(cfg.n_groups):
        slot_params = _group(params["groups"], g)
        slot_cache = _group(cache["groups"], g)
        for i, kind in enumerate(cfg.pattern):
            blk = slot_cache[f"slot{i}"]
            x, _ = block_apply(cfg, kind, slot_params[f"slot{i}"], x,
                               positions=positions, moe_layer=cfg.moe,
                               cache={"attn": {**blk["attn"], "pos": pos}})
    x = L.rmsnorm_apply(cfg, params["final_norm"], x)
    return L.unembed_apply(cfg, params["embed"], x), cache
