"""Transformer building blocks: the attention, MLP and embedding pieces of
``repro.models.layers`` in PyTorch.

Every block ships a ``*_defs(cfg)`` returning a ParamInfo tree and a
``*_apply(cfg, params, ...)`` function on tensors.  Attention supports
GQA/MQA, RoPE, a causal mask with an optional sliding window, QKV bias, and
single-token decode with one shared position clock or one per slot, against
a dense KV cache or, for a windowed layer (mixtral's ``attn_local``), a
ring-buffer cache of the window's length.  It goes through
``kernels.ops.attention``: the Hopper kernel for CUDA tensors, its plain
version for CPU tensors.  Cross attention (llama-3.2-vision's ``cross``
blocks) projects K/V from another stream (``kv_x``, the image embeddings)
and attends to all of it, with no RoPE, mask or cache, through
``kernels.ops.cross_attention``.  ``cfg.logit_softcap`` > 0 caps every
scaled logit, self, cross and decode, inside the kernels.  Embeddings are
tied (the token table unembeds) or untied (an ``unembed`` leaf).  The
``shard`` calls are the reference's sharding constraints: no-ops on the
card's plain tensors, redistributions of the dry run's DTensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import (current_mesh, entry_dims, is_dtensor,
                                    local_by_axes, mesh_dims, pspec, shard)
from ..kernels import ops
from ..kernels.ref import BLOCKED_ATTN_THRESHOLD
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

def attention_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    """Self attention's projections; ``cross``: wk and wv take
    ``cfg.cross_attn_dim`` wide inputs (the image embeddings)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_in = cfg.cross_attn_dim if cross else d
    defs = {
        "wq": ParamInfo((d, h, hd), cfg.param_dtype, (None, "heads", None),
                        fsdp_dim=0),
        "wk": ParamInfo((kv_in, kv, hd), cfg.param_dtype,
                        (None, "kv_heads", None), fsdp_dim=0),
        "wv": ParamInfo((kv_in, kv, hd), cfg.param_dtype,
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


def _flat_proj(x, w):
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _proj(x, w, heads: str):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product.

    Under a mesh (DTensors) the flat product must not be split inside a
    head, which a DTensor cannot unflatten: where the ``heads`` axis
    shards whole heads, the product is laid out so; where it cannot (8 kv
    heads on a 16-way dim), each device multiplies its rows by the whole
    weight (``local_map``, the weight gathered)."""
    if not is_dtensor(x):
        return _flat_proj(x, w)
    spec = pspec("batch", None, heads, None, shape=(*x.shape[:2],
                                                    *w.shape[1:]))
    if spec[2]:
        y = shard(x @ w.reshape(w.shape[0], -1), "batch", None, heads)
        return y.unflatten(-1, w.shape[1:])
    return local_by_axes(
        _flat_proj, (x, w), [("batch", None, None), (None,) * 3],
        [(("batch", None, None, None), (*x.shape[:2], *w.shape[1:]))])


def rows_matmul(x, w):
    """``x @ w`` for a replicated ``w`` [d, n].  Under a mesh each device
    multiplies only its own rows, its slice of the batch and of the
    sequence (``local_map``: DTensor cannot fold the two sharded dims into
    one), where DTensor would multiply every row of its batch slice."""
    if not is_dtensor(x):
        return x @ w
    rows = ("batch", "seq", None)
    return local_by_axes(torch.matmul, (x, w), [rows, (None, None)],
                         [(rows, (*x.shape[:-1], w.shape[-1]))])


def _head_sum(o, w):
    """einsum("bshk,hkd->bsd", o, w) as one matrix product."""
    return o.flatten(2) @ w.flatten(0, 1)


def _out_proj(out, wo):
    """The output projection over the heads.  Under a mesh whose model dim
    cannot take whole heads (14 on 16) each device multiplies its rows by
    the whole weight (``local_map``), as ``_proj`` does: DTensor would
    split the flat rows over the model dim and its backward then fails
    on fake tensors."""
    if not is_dtensor(out) or pspec("heads", shape=wo.shape[:1])[0]:
        return _head_sum(out, wo)
    return local_by_axes(
        _head_sum, (out, wo), [("batch", None, None, None), (None,) * 3],
        [(("batch", None, None), (*out.shape[:2], wo.shape[-1]))])


def kv_repeats(n_heads: int, n_kv_heads: int) -> int:
    """How many copies of each kv head a mesh needs: where its model dim
    splits the query heads but not the kv heads (llama's 32 and 8 on 16),
    each kv head is repeated so that the model dim splits the copies too,
    and each device holds the one kv head its query heads read (GQA's
    grouping of the copies is the original's).  1 without a mesh, or
    where the kv heads split, or where the dim is not a multiple of
    them."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    on_q = pspec("heads", shape=(n_heads,))[0]
    if not on_q or pspec("kv_heads", shape=(n_kv_heads,))[0]:
        return 1
    dims = mesh_dims(mesh)
    n = int(np.prod([dims[a] for a in entry_dims(on_q)]))
    return n // n_kv_heads if n % n_kv_heads == 0 else 1


def _repeat_heads(w, reps: int, dim: int):
    """Each head of ``w`` (its ``dim``) ``reps`` times in a row, the copies
    laid out over the model dim with the kv heads'."""
    w = w.unsqueeze(dim + 1).expand(*w.shape[:dim + 1], reps,
                                    *w.shape[dim + 1:]).flatten(dim, dim + 1)
    return shard(w, *[None] * dim, "kv_heads", *[None] * (w.dim() - dim - 1))


def _qkv(cfg: ModelConfig, p, x, kv_x, reps: int = 1):
    """The projections; ``reps`` > 1 (a mesh, no cache): each kv head
    ``reps`` times (:func:`kv_repeats`)."""
    dt = adtype(cfg)
    wk, wv = p["wk"].to(dt), p["wv"].to(dt)
    if reps > 1:
        wk, wv = _repeat_heads(wk, reps, 1), _repeat_heads(wv, reps, 1)
    q = _proj(x, p["wq"].to(dt), "heads")
    k = _proj(kv_x, wk, "kv_heads")
    v = _proj(kv_x, wv, "kv_heads")
    if cfg.qkv_bias:
        bk, bv = p["bk"].to(dt), p["bv"].to(dt)
        if reps > 1:
            bk, bv = _repeat_heads(bk, reps, 0), _repeat_heads(bv, reps, 0)
        q = q + p["bq"].to(dt)
        k = k + bk
        v = v + bv
    return q, k, v


def write_rows(cache, at, new, keep=None):
    """``cache`` [B,L,...] with row ``at[b]`` of slot b set to ``new[b]``
    (where ``keep[b]``), as a select over the rows: a new tensor.  The
    decode step writes its cache in place by index on the card; a DTensor
    cache (the dry run's, its rows perhaps sharded) takes this form, which
    every placement supports."""
    hit = (torch.arange(cache.shape[1], device=at.device)[None, :]
           == at.reshape(-1, 1))
    if keep is not None:
        hit = hit & keep.reshape(-1, 1)
    hit = hit.reshape(*hit.shape, *[1] * (cache.dim() - 2))
    return torch.where(hit, new[:, None].to(cache.dtype), cache)


def _like_cache(new, cache):
    """A step's new rows ``new`` [B,1,KV,D] laid out as the DTensor
    ``cache`` [B,L,KV,D] is, replicated over the mesh dims its sequence is
    split on, so that :func:`write_rows` selects rows where the cache lies
    and moves none of it: where the rows split the kv heads and the cache
    does not (musicgen's 32 on the model dim, which the cache's sequence
    takes), DTensor would redistribute the whole cache to the rows'
    layout."""
    from torch.distributed.tensor import Replicate
    return new.redistribute(cache.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in cache.placements])


def attention_apply(cfg: ModelConfig, p, x, *, positions, window: int = 0,
                    cache: Optional[dict] = None, kv_x=None):
    """Causal self-attention; ``window`` > 0 limits each query to the last
    ``window`` positions.  With ``kv_x`` ([B,N,cross_attn_dim]), cross
    attention instead.

    Train (cache None): full-sequence causal (+window) attention.
    Decode (cache dict with k [B,L,KV,D], v, pos): x is [B,1,D]; ``pos`` is
    one shared position clock (a scalar) or one per slot (``[B]``).  Each
    slot writes its new key/value at its position and attends over the
    positions up to it.  With a window the cache is a ring of length
    L <= window: slot b writes row pos[b] mod L.  The cache is updated in
    place (JAX returns a new one and donates the old); the returned dict
    holds the same tensors.

    Cross attention: K/V are projected from ``kv_x`` on every call, decode
    included (the reference recomputes them each step and caches nothing);
    every query sees every key, with no RoPE.  Returns ``(y, None)``.
    """
    b, s, _ = x.shape
    cross = kv_x is not None
    # Under a mesh the attention of a whole sequence reads each kv head on
    # the devices of its query heads (a decode step writes the cache's
    # own heads).
    reps = kv_repeats(cfg.n_heads, cfg.n_kv_heads) \
        if cache is None and is_dtensor(x) else 1
    q, k, v = _qkv(cfg, p, x, kv_x if cross else x, reps)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)

    new_cache = None
    cap = cfg.logit_softcap
    if cross:
        out = ops.cross_attention(q, k, v, softcap=cap)
    elif cache is None:
        out = ops.attention(q, k, v, window=window, softcap=cap)
    else:
        pos = cache["pos"]
        if pos.dim() > 1 or s != 1:
            raise ValueError("decode takes one token per slot and a scalar "
                             "or [B] position clock")
        k_all, v_all = cache["k"], cache["v"]
        length = k_all.shape[1]
        rows = torch.arange(b, device=pos.device)
        slot_pos = pos.expand(b) if pos.dim() == 0 else pos
        if is_dtensor(k_all):
            if window > 0:
                at, keep = torch.remainder(slot_pos, length), None
            else:
                at = slot_pos.clamp(max=length - 1)
                keep = None if pos.dim() == 0 else slot_pos < length
            k_all = write_rows(k_all, at, _like_cache(k, k_all)[:, 0], keep)
            v_all = write_rows(v_all, at, _like_cache(v, v_all)[:, 0], keep)
        elif window > 0:
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
        # A sequence-sharded cache (context parallelism): each device
        # attends its own rows, merged by log-sum-exp.
        out = ops.split_kv_attention(q, k_all, v_all, kv_len=kv_len,
                                     softcap=cap)
        if out is None:
            out = ops.attention(q, k_all, v_all, kv_len=kv_len, softcap=cap)
        else:
            out = shard(out, "batch", None, "heads", None)
        new_cache = {"k": k_all, "v": v_all, "pos": pos + 1}

    y = _out_proj(out, p["wo"].to(adtype(cfg)))
    # The reference's blocked path (from BLOCKED_ATTN_THRESHOLD rows) keeps
    # its output's sequence on the "seq" rule.
    blocked = cache is None and not cross and s >= BLOCKED_ATTN_THRESHOLD
    return shard(y, "batch", "seq" if blocked else None, "embed"), new_cache


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
    h = shard(act(g) * h, "batch", None, "mlp")
    return shard(h @ p["wo"].to(dt), "batch", None, "embed")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict:
    """The token table; untied models add an ``unembed`` [d, vocab].  A
    codebook model (musicgen) has ``n_codebooks`` K of each: ``tokens``
    [K, vocab, d] and ``unembed`` [K, d, vocab]."""
    if cfg.n_codebooks > 0:
        k = cfg.n_codebooks
        return {
            "tokens": ParamInfo((k, cfg.vocab, cfg.d_model),
                                cfg.param_dtype, (None, "vocab", None),
                                fsdp_dim=2, init_scale=1.0),
            "unembed": ParamInfo((k, cfg.d_model, cfg.vocab),
                                 cfg.param_dtype, (None, None, "vocab"),
                                 fsdp_dim=1),
        }
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
    JAX model's ``_embed`` does.  Codebook tokens [B,S,K]: the sum of the K
    tables' rows, in codebook order."""
    dt = adtype(cfg)
    if cfg.n_codebooks > 0:
        tabs = p["tokens"].to(dt)
        x = sum(F.embedding(tokens[..., i].long(), tabs[i])
                for i in range(cfg.n_codebooks))
    else:
        x = F.embedding(tokens.long(), p["tokens"].to(dt))
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=dt))
    return shard(x, "batch", "seq", "embed")


def unembed_apply(cfg: ModelConfig, p, x):
    """Logits [B,S,vocab]; [B,S,K,vocab] for codebooks (one matrix product
    over the K heads side by side: ``einsum("bsd,kdv->bskv")``)."""
    dt = adtype(cfg)
    if cfg.n_codebooks > 0:
        w = p["unembed"].to(dt)                        # [K, d, V]
        k, d, v = w.shape
        if is_dtensor(w):    # K products: a sharded vocab cannot fold
            logits = torch.stack([x @ w[i] for i in range(k)], dim=-2)
        else:
            logits = (x @ w.permute(1, 0, 2).reshape(d, k * v)).unflatten(
                -1, (k, v))
    elif cfg.tie_embeddings:
        logits = x @ p["tokens"].to(dt).T
    else:
        logits = x @ p["unembed"].to(dt)
    return shard(logits, "batch", None, "vocab")
