"""Model assembly: stacked layer groups, full-sequence forward and loss,
decode step.

The counterpart of ``repro.models.model``.  A config's layers are an
optional stack of ``n_dense_layers`` dense-FFN attention blocks
(``dense``, deepseek's leading layers), ``n_groups`` groups of
``cfg.pattern`` (``groups``) and one group of ``cfg.tail`` (``tail``,
gemma3's and recurrentgemma's remainder layers), in that order.  A group
mixes any of the block kinds ``attn``, sliding-window ``attn_local``,
``cross`` (llama-3.2-vision: self attention, then cross attention to the
image embeddings ``img_embed``), ``rglru`` (Griffin's recurrent block,
``models.rglru``) and ``rwkv`` (rwkv6: time-mix and channel-mix); each
attention block has a SwiGLU or GeGLU MLP or an MoE FFN (routed experts,
and deepseek's shared ones), with GQA attention or deepseek's latent
attention (``models.mla``).  Embeddings are tied or untied; gemma models
scale theirs by sqrt(d_model); a codebook model (musicgen) embeds
``[B,S,K]`` tokens as the sum of K tables and unembeds through K heads to
``[B,S,K,vocab]`` logits; ``logit_softcap`` caps the attention logits.
Parameters keep the JAX tree's layout and key paths (``embed.tokens``,
``groups.slot0.attn.wq``, ...): each leaf of a stack is stacked
``[layers, ...]``, and the JAX package's ``lax.scan`` over a stack becomes
a Python loop over that leading axis.  Every remat policy of the
reference (``none``, ``full``, ``dots``, ``dtr``, ``names:a,b``) wraps each
group and each dense layer in ``torch.utils.checkpoint`` with a
selective-checkpoint policy (:func:`remat_policy`, the JAX
``checkpoint_policies`` on the scan bodies); ``core.remat.tag``, the
counterpart of ``checkpoint_name``, marks each block's ``attn_out``,
``cross_out``, ``rec_out`` and ``ffn_out`` (a copy only where a policy
reads the names: ``dtr``, ``names:``, and the planner's trace).  Decode
takes one shared position clock (a scalar ``pos``) or per-slot clocks
(``[B]``); a
windowed layer's KV cache is a ring buffer; an rwkv block's cache is its
f32 recurrent state and the two token-shift rows, an rglru block's its
state ``h`` and the conv's last inputs, none of which carry a position.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core import remat as R
from ..distributed.sharding import is_dtensor, shard, vocab_parallel_nll
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import rwkv as RW
from .config import ModelConfig
from .params import TORCH_DTYPES, ParamInfo, tree_map

# The stacked trees, ``[layers, ...]`` leaves, in the order they run: the
# leading dense layers (deepseek), the groups of ``cfg.pattern`` and the
# one group of ``cfg.tail``.
STACKS = ("dense", "groups", "tail")
# Leaves read in float32 whatever the activation dtype: norm scales (MLA's
# too), the MoE router and the RG-LRU's decay parameter.
_READ_IN_F32 = ("scale", "router", "q_norm", "kv_norm", "lam")
_KINDS = ("attn", "attn_local", "cross", "rglru", "rwkv")

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "pattern": any(k not in _KINDS for k in cfg.pattern + cfg.tail),
        "mlp_act": cfg.mlp_act not in ("silu", "gelu"),
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not supported (the model, as "
            f"the reference's, runs groups and a tail of "
            f"{', '.join(_KINDS)} blocks, GQA or MLA with an optional logit "
            f"soft cap, with SwiGLU, GeGLU or MoE FFNs after optional dense "
            f"layers)")


def _block_defs(cfg: ModelConfig, kind: str, moe_layer: bool) -> dict:
    d = {"norm1": L.rmsnorm_defs(cfg), "norm2": L.rmsnorm_defs(cfg)}
    if kind == "rwkv":
        d["mix"] = RW.rwkv_defs(cfg)
    elif kind == "rglru":
        d["rec"] = RG.rglru_defs(cfg)
        d["ffn"] = L.mlp_defs(cfg)
    else:
        d["attn"] = MLA.mla_defs(cfg) if cfg.mla else L.attention_defs(cfg)
        if kind == "cross":
            d["norm_c"] = L.rmsnorm_defs(cfg)
            d["cross"] = L.attention_defs(cfg, cross=True)
        d["ffn"] = MOE.moe_defs(cfg) if moe_layer else L.mlp_defs(cfg)
    return d


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
    defs = {"embed": L.embed_defs(cfg)}
    if cfg.n_dense_layers:
        defs["dense"] = _stack_tree(_block_defs(cfg, "attn", False),
                                    cfg.n_dense_layers)
    group = {f"slot{i}": _block_defs(cfg, kind, moe_layer=cfg.moe)
             for i, kind in enumerate(cfg.pattern)}
    defs["groups"] = _stack_tree(group, cfg.n_groups)
    if cfg.tail:
        tail = {f"slot{i}": _block_defs(cfg, kind, moe_layer=cfg.moe)
                for i, kind in enumerate(cfg.tail)}
        defs["tail"] = _stack_tree(tail, 1)
    defs["final_norm"] = L.rmsnorm_defs(cfg)
    return defs


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
    (MLA's ``q_norm`` and ``kv_norm`` too) and the MoE router stay in their
    own dtype: all are read in float32."""
    dt = L.adtype(cfg)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else v if k in _READ_IN_F32 else v.to(dt)
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# Remat policy (the paper's technique, applied to each group)
# ---------------------------------------------------------------------------

def remat_policy(cfg: ModelConfig):
    """The group body's selective-checkpoint policy, None for ``none``:
    ``full`` saves nothing, ``dots`` the outputs of matrix products with no
    batch dims (``mm``/``addmm``, not ``bmm``), ``dtr`` the ``attn_out`` and
    ``ffn_out`` tags (not ``cross_out``, as in the reference), ``names:a,b``
    the tags named."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return R.nothing_saveable
    if cfg.remat == "dots":
        return R.dots_with_no_batch_dims_saveable
    if cfg.remat == "dtr":
        # The reference's default plan: save the block outputs only.
        return R.save_only_these_names("attn_out", "ffn_out")
    if cfg.remat.startswith("names:"):
        return R.save_only_these_names(
            *[n for n in cfg.remat[6:].split(",") if n])
    raise ValueError(cfg.remat)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x):
    """RMS norm, its output gathered over the sequence where a mesh shards
    the residual stream's ("seq" -> "model", sequence parallelism): the
    matrix products after it take whole rows (no-op without a mesh)."""
    return shard(L.rmsnorm_apply(cfg, p, x), "batch", None, "embed")


def _to_stream(y):
    """A branch's output laid out as the residual stream (no-op without a
    mesh).  Under sequence parallelism DTensor would otherwise split the
    branch inside the add, out of autograd's sight, and hand its backward
    a gradient sharded over batch and sequence at once, which the
    recurrent blocks' products cannot take."""
    return shard(y, "batch", "seq", "embed")


def block_apply(cfg: ModelConfig, kind: str, p, x, *, positions,
                moe_layer: bool, cache=None, img_kv=None):
    """Pre-norm residual block; returns (x, new_cache).  The attention
    (time-mix), recurrence and FFN (channel-mix) outputs are tagged
    ``attn_out``, ``rec_out`` and ``ffn_out``; a ``cross`` block adds its
    cross attention to ``img_kv`` after the self attention, tagged
    ``cross_out``."""
    if kind == "rglru":
        rec_cache = None if cache is None else cache.get("rec")
        h = _norm(cfg, p["norm1"], x)
        r, c2 = RG.rglru_apply(cfg, p["rec"], h, cache=rec_cache)
        x = x + R.tag(_to_stream(r), "rec_out")
        h2 = _norm(cfg, p["norm2"], x)
        x = x + R.tag(_to_stream(L.mlp_apply(cfg, p["ffn"], h2)), "ffn_out")
        return shard(x, "batch", "seq", "embed"), (None if c2 is None
                                                     else {"rec": c2})
    if kind == "rwkv":
        mix_cache = None if cache is None else cache.get("mix")
        h = _norm(cfg, p["norm1"], x)
        if mix_cache is None:
            x = x + R.tag(_to_stream(RW.rwkv_time_mix(cfg, p["mix"], h)),
                          "attn_out")
            h2 = _norm(cfg, p["norm2"], x)
            x = x + R.tag(_to_stream(RW.rwkv_channel_mix(cfg, p["mix"], h2)),
                          "ffn_out")
            return shard(x, "batch", "seq", "embed"), None
        t, c2 = RW.rwkv_time_mix(cfg, p["mix"], h, cache=mix_cache)
        x = x + R.tag(t, "attn_out")
        h2 = _norm(cfg, p["norm2"], x)
        f, c3 = RW.rwkv_channel_mix(cfg, p["mix"], h2, cache=mix_cache)
        return (shard(x + R.tag(f, "ffn_out"), "batch", "seq", "embed"),
                {"mix": {**c2, **c3}})
    h = _norm(cfg, p["norm1"], x)
    window = cfg.window if kind == "attn_local" else 0
    attn_cache = None if cache is None else cache.get("attn")
    if cfg.mla:
        a, c2 = MLA.mla_apply(cfg, p["attn"], h, positions=positions,
                              cache=attn_cache)
    else:
        a, c2 = L.attention_apply(cfg, p["attn"], h, positions=positions,
                                  window=window, cache=attn_cache)
    x = x + R.tag(a, "attn_out")
    if kind == "cross":
        hc = _norm(cfg, p["norm_c"], x)
        ca, _ = L.attention_apply(cfg, p["cross"], hc, positions=positions,
                                  kv_x=img_kv)
        x = x + R.tag(ca, "cross_out")
    h2 = _norm(cfg, p["norm2"], x)
    ffn = MOE.moe_apply if moe_layer else L.mlp_apply
    x = x + R.tag(ffn(cfg, p["ffn"], h2), "ffn_out")
    return shard(x, "batch", "seq", "embed"), (None if c2 is None
                                                 else {"attn": c2})


def _stacks(cfg: ModelConfig):
    """``(stack, layers, kinds)`` in the order the layers run: the dense
    layers (each one ``attn`` block, with a dense FFN), the groups of
    ``cfg.pattern``, then the tail's one group of ``cfg.tail``."""
    stacks = zip(STACKS, (cfg.n_dense_layers, cfg.n_groups,
                          1 if cfg.tail else 0),
                 (("attn",), cfg.pattern, cfg.tail))
    return [(k, n, kinds) for k, n, kinds in stacks if n]


def _blocks(cfg: ModelConfig, stack: str, kinds, slot_params, slot_cache):
    """``(kind, params, cache, moe_layer)`` of each block of one layer
    (``dense``) or group; ``slot_cache`` None in training."""
    if stack == "dense":
        return [("attn", slot_params, slot_cache, False)]
    return [(kind, slot_params[f"slot{i}"],
             None if slot_cache is None else slot_cache[f"slot{i}"], cfg.moe)
            for i, kind in enumerate(kinds)]


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def has_cross(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has ``cross`` blocks, which attend to ``img_embed``."""
    return "cross" in cfg.pattern + cfg.tail


def _img_kv(cfg: ModelConfig, img_embed):
    """``img_embed`` in the activation dtype, cast once for every cross
    block; a config with ``cross`` blocks needs it."""
    if img_embed is None:
        if has_cross(cfg):
            raise ValueError(f"{cfg.name}: cross blocks attend to img_embed "
                             f"[B, {cfg.cross_attn_tokens}, "
                             f"{cfg.cross_attn_dim}]; none was given")
        return None
    return img_embed.to(L.adtype(cfg))


def forward(cfg: ModelConfig, params, tokens, img_embed=None):
    """Full-sequence forward -> logits.

    tokens: [B,S] int (or [B,S,K] for codebook models: logits
    [B,S,K,vocab]).  img_embed: [B,N,cross_attn_dim] for a model with
    ``cross`` blocks (the vision frontend's output)."""
    policy = remat_policy(cfg)
    x = L.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    img_kv = _img_kv(cfg, img_embed)
    for stack, layers, kinds in _stacks(cfg):
        for g in range(layers):
            blocks = _blocks(cfg, stack, kinds, _group(params[stack], g),
                             None)

            def body(h, blocks=blocks):
                for kind, blk_params, _, moe_layer in blocks:
                    h, _ = block_apply(cfg, kind, blk_params, h,
                                       positions=positions,
                                       moe_layer=moe_layer, img_kv=img_kv)
                return h

            # Any remat: keep each layer's input and what the policy saves;
            # the backward runs the layer's forward again.
            x = body(x) if policy is None \
                else R.checkpointed(body, policy)(x)
    x = _norm(cfg, params["final_norm"], x)
    return L.unembed_apply(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross entropy (f32 logits for the softmax); for codebook
    models the mean over batch, positions and codebooks.  ``batch`` holds
    ``tokens`` and, for a model with ``cross`` blocks, ``img_embed``."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens, batch.get("img_embed")).float()
    inp, tgt = logits[:, :-1], tokens[:, 1:].long()
    if is_dtensor(inp):   # under a mesh: the logits stay vocab-sharded
        return vocab_parallel_nll(inp, tgt)
    logp = F.log_softmax(inp, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Decode (serve)
# ---------------------------------------------------------------------------

def _block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                      max_len: int) -> dict:
    if kind == "rwkv":
        return {"mix": RW.rwkv_cache_defs(cfg, batch)}
    if kind == "rglru":
        return {"rec": RG.rglru_cache_defs(cfg, batch)}
    if cfg.mla:
        return {"attn": MLA.mla_cache_defs(cfg, batch, max_len)}
    window = cfg.window if kind == "attn_local" else 0
    return {"attn": L.attn_cache_defs(cfg, batch, max_len, window)}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    _check_supported(cfg)
    defs = {}
    if cfg.n_dense_layers:
        defs["dense"] = _stack_tree(
            _block_cache_defs(cfg, "attn", batch, max_len),
            cfg.n_dense_layers)
    group = {f"slot{i}": _block_cache_defs(cfg, kind, batch, max_len)
             for i, kind in enumerate(cfg.pattern)}
    defs["groups"] = _stack_tree(group, cfg.n_groups)
    if cfg.tail:
        tail = {f"slot{i}": _block_cache_defs(cfg, kind, batch, max_len)
                for i, kind in enumerate(cfg.tail)}
        defs["tail"] = _stack_tree(tail, 1)
    return defs


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str):
    return tree_map(
        lambda i: torch.zeros(i.shape, dtype=TORCH_DTYPES[i.dtype],
                              device=device),
        cache_defs(cfg, batch, max_len))


def decode_step(cfg: ModelConfig, params, token, cache, pos,
                img_embed=None):
    """One-token decode: token [B,1] (or [B,1,K] for codebooks) at position
    ``pos``, a scalar (one shared position clock) or a ``[B]`` vector
    (per-slot clocks, continuous batching: each slot's request sits at its
    own position).  ``img_embed`` [B,N,cross_attn_dim]: the image the
    ``cross`` blocks attend to, its K/V projected anew every step.

    Returns (logits, cache).  The cache is updated in place and returned;
    ``pos`` reaches the attention caches only (recurrent state carries no
    position).
    """
    x = L.embed_apply(cfg, params["embed"], token)
    img_kv = _img_kv(cfg, img_embed)
    # rope wants positions broadcastable to [B, S] with S = 1.
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    for stack, layers, kinds in _stacks(cfg):
        for g in range(layers):
            blocks = _blocks(cfg, stack, kinds, _group(params[stack], g),
                             _group(cache[stack], g))
            for kind, blk_params, blk, moe_layer in blocks:
                # The position clock goes to the attention caches (dense KV
                # or MLA latents), not to a recurrent state.
                blk_cache = {k: {**v, "pos": pos}
                             if "k" in v or "ckv" in v else v
                             for k, v in blk.items()}
                x, new = block_apply(cfg, kind, blk_params, x,
                                     positions=positions,
                                     moe_layer=moe_layer, cache=blk_cache,
                                     img_kv=img_kv)
                for state in ("mix", "rec"):
                    # A recurrent state is returned anew: write it back.
                    for k, t in blk.get(state, {}).items():
                        t.copy_(new[state][k])
    x = _norm(cfg, params["final_norm"], x)
    return L.unembed_apply(cfg, params["embed"], x), cache
