"""Transformer building blocks: the dense and sliding-window attention
pieces of ``repro.models.layers`` in PyTorch (qwen2, mixtral).

Every block ships a ``*_defs(cfg)`` returning a ParamInfo tree and a
``*_apply(cfg, params, ...)`` function on tensors.  Attention supports
GQA/MQA, RoPE, a causal mask with an optional sliding window, QKV bias, and
single-token decode with one shared position clock or one per slot, against
a dense KV cache or, for a windowed layer (mixtral's ``attn_local``), a
ring-buffer cache of the window's length.  It goes through
``kernels.ops.attention``: the Hopper kernel for CUDA tensors, its plain
version for CPU tensors.  Embeddings are tied (the token table unembeds)
or untied (an ``unembed`` leaf).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .params import TORCH_DTYPES, ParamInfo


def adtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(cfg: ModelConfig) -> dict:
    return {"scale": ParamInfo((cfg.d_model,), cfg.param_dtype, ("embed",),
                               init_scale=0.0)}


def rmsnorm_apply(cfg: ModelConfig, p, x):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + cfg.norm_eps)
    return (y * (1.0 + p["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    # The same numpy float32 expression as the JAX package, so that angles
    # near max_len agree to the ulp.
    freqs = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ).to(x.device)
    ang = positions[..., :, None, None].float() * freqs   # [...,S,1,half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamInfo((d, h, hd), cfg.param_dtype, (None, "heads", None),
                        fsdp_dim=0),
        "wk": ParamInfo((d, kv, hd), cfg.param_dtype,
                        (None, "kv_heads", None), fsdp_dim=0),
        "wv": ParamInfo((d, kv, hd), cfg.param_dtype,
                        (None, "kv_heads", None), fsdp_dim=0),
        "wo": ParamInfo((h, hd, d), cfg.param_dtype, ("heads", None, None),
                        fsdp_dim=2),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamInfo((h, hd), cfg.param_dtype, ("heads", None),
                               init_scale=0.0)
        defs["bk"] = ParamInfo((kv, hd), cfg.param_dtype, ("kv_heads", None),
                               init_scale=0.0)
        defs["bv"] = ParamInfo((kv, hd), cfg.param_dtype, ("kv_heads", None),
                               init_scale=0.0)
    return defs


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _qkv(cfg: ModelConfig, p, x):
    dt = adtype(cfg)
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def attention_apply(cfg: ModelConfig, p, x, *, positions, window: int = 0,
                    cache: Optional[dict] = None):
    """Causal self-attention; ``window`` > 0 limits each query to the last
    ``window`` positions.

    Train (cache None): full-sequence causal (+window) attention.
    Decode (cache dict with k [B,L,KV,D], v, pos): x is [B,1,D]; ``pos`` is
    one shared position clock (a scalar) or one per slot (``[B]``).  Each
    slot writes its new key/value at its position and attends over the
    positions up to it.  With a window the cache is a ring of length
    L <= window: slot b writes row pos[b] mod L.  The cache is updated in
    place (JAX returns a new one and donates the old); the returned dict
    holds the same tensors.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None:
        out = ops.attention(q, k, v, window=window)
    else:
        pos = cache["pos"]
        if pos.dim() > 1 or s != 1:
            raise ValueError("decode takes one token per slot and a scalar "
                             "or [B] position clock")
        k_all, v_all = cache["k"], cache["v"]
        length = k_all.shape[1]
        rows = torch.arange(b, device=pos.device)
        slot_pos = pos.expand(b) if pos.dim() == 0 else pos
        if window > 0:
            if length > window:
                raise ValueError(f"a windowed cache is a ring of at most "
                                 f"window={window} rows, got {length}")
            # Ring buffer: row j holds absolute position
            # pos - ((pos - j) mod L), so every write lands in range.
            at = torch.remainder(slot_pos, length)
            k_all[rows, at] = k[:, 0]
            v_all[rows, at] = v[:, 0]
        elif pos.dim() == 0:
            # JAX's dynamic_update_slice clamps its start into range: a
            # shared clock at or past L overwrites row L - 1.
            at = pos.clamp(max=length - 1)
            k_all[:, at] = k[:, 0]
            v_all[:, at] = v[:, 0]
        else:
            # JAX drops a scatter whose index is out of range (an idle slot
            # whose clock ran to max_len); a torch index would raise.  Write
            # such rows back unchanged instead.
            keep = (pos < length)[:, None, None]
            at = pos.clamp(max=length - 1)
            k_all[rows, at] = torch.where(keep, k[:, 0], k_all[rows, at])
            v_all[rows, at] = torch.where(keep, v[:, 0], v_all[rows, at])
        # Slot b sees cache rows < min(pos[b] + 1, L): the JAX package's
        # decode_mask, and for a ring its ``abs_pos >= 0`` (rows 0..pos
        # until the ring wraps, then all of them, which lie inside the
        # window).  Softmax does not depend on the order of the keys, so
        # the ring needs no window inside the kernel.
        kv_len = (slot_pos + 1).clamp(max=length).to(torch.int32)
        out = ops.attention(q, k_all, v_all, kv_len=kv_len)
        new_cache = {"k": k_all, "v": v_all, "pos": pos + 1}

    dt = adtype(cfg)
    wo = p["wo"].to(dt)
    y = out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache


def attn_cache_defs(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0) -> dict:
    """KV-cache ParamInfo tree for one attention layer; a windowed layer
    keeps a ring of ``min(max_len, window)`` rows."""
    s = min(max_len, window) if window > 0 else max_len
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": ParamInfo((batch, s, kv, hd), cfg.dtype,
                       ("batch", "kv_seq", "kv_heads", None)),
        "v": ParamInfo((batch, s, kv, hd), cfg.dtype,
                       ("batch", "kv_seq", "kv_heads", None)),
    }


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU, or GeGLU for ``mlp_act`` gelu)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wi": ParamInfo((d, f), cfg.param_dtype, (None, "mlp"), fsdp_dim=0),
        "wg": ParamInfo((d, f), cfg.param_dtype, (None, "mlp"), fsdp_dim=0),
        "wo": ParamInfo((f, d), cfg.param_dtype, ("mlp", None), fsdp_dim=1),
    }


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation, not the erf
    form."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p, x):
    dt = adtype(cfg)
    act = F.silu if cfg.mlp_act == "silu" else gelu
    h = x @ p["wi"].to(dt)
    g = x @ p["wg"].to(dt)
    return (act(g) * h) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict:
    """The token table; untied models add an ``unembed`` [d, vocab]."""
    defs = {"tokens": ParamInfo((cfg.vocab, cfg.d_model), cfg.param_dtype,
                                ("vocab", None), fsdp_dim=1,
                                init_scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamInfo((cfg.d_model, cfg.vocab),
                                    cfg.param_dtype, (None, "vocab"),
                                    fsdp_dim=0)
    return defs


def embed_apply(cfg: ModelConfig, p, tokens):
    """The token rows; gemma models (``gemma*``, ``recurrentgemma*``) scale
    them by sqrt(d_model), rounded to the activation dtype first, as the
    JAX model's ``_embed`` does."""
    dt = adtype(cfg)
    x = F.embedding(tokens.long(), p["tokens"].to(dt))
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=dt))
    return x


def unembed_apply(cfg: ModelConfig, p, x):
    dt = adtype(cfg)
    if cfg.tie_embeddings:
        return x @ p["tokens"].to(dt).T
    return x @ p["unembed"].to(dt)
