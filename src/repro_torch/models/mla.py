"""Multi-head Latent Attention (deepseek-v3): the counterpart of
``repro.models.mla``.

Queries and keys/values are low-rank compressed: ``wq_a`` then an RMS norm
then ``wq_b`` for the queries, ``wkv_a`` into a ``kv_lora_rank`` latent (RMS
normed) and one shared ``qk_rope_dim`` RoPE key.  Only the latent ``ckv``
and the RoPE key ``krope`` are cached at decode.  Training expands the
latent to per-head keys (``wk_b``, nope part) and values (``wv_b``); decode
uses the absorbed form, scores and values in latent space.

Attention here is plain PyTorch, as the reference computes MLA's outside
any Pallas kernel (einsums and ``_sdpa_blocked``): below
``BLOCKED_ATTN_THRESHOLD`` query rows the dense logits, from it on a loop
over blocks of 512 query rows on the concatenated 192-wide q/k
(``qk_nope_dim + qk_rope_dim``) against the 128-wide v, each block under a
checkpoint so the backward recomputes it.  The flash kernel takes one head
dim for q, k and v (and its backward at most 128), so it cannot run this
attention: MLA layers launch no flash kernel (ROADMAP H3).
The scale is ``1/sqrt(qk_nope_dim + qk_rope_dim)``.  ``logit_softcap`` caps
the logits of the blocked path alone, where the reference's
``_sdpa_blocked`` caps them; its dense and decode paths do not (ROADMAP
Queue 3).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ref import BLOCKED_ATTN_THRESHOLD, Q_BLOCK
from .config import ModelConfig
from ..distributed.sharding import is_dtensor, local_by_axes, shard
from .layers import adtype, rope, rows_matmul, write_rows
from .params import ParamInfo


def mla_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rop, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamInfo((d, ql), cfg.param_dtype, (None, None),
                          fsdp_dim=0),
        "q_norm": ParamInfo((ql,), cfg.param_dtype, (None,), init_scale=0.0),
        "wq_b": ParamInfo((ql, h, nope + rop), cfg.param_dtype,
                          (None, "heads", None), fsdp_dim=0),
        "wkv_a": ParamInfo((d, kl + rop), cfg.param_dtype, (None, None),
                           fsdp_dim=0),
        "kv_norm": ParamInfo((kl,), cfg.param_dtype, (None,),
                             init_scale=0.0),
        "wk_b": ParamInfo((kl, h, nope), cfg.param_dtype,
                          (None, "heads", None), fsdp_dim=0),
        "wv_b": ParamInfo((kl, h, vd), cfg.param_dtype,
                          (None, "heads", None), fsdp_dim=0),
        "wo": ParamInfo((h, vd, d), cfg.param_dtype,
                        ("heads", None, None), fsdp_dim=2),
    }


def mla_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return {
        "ckv": ParamInfo((batch, max_len, cfg.kv_lora_rank), cfg.dtype,
                         ("batch", "kv_seq", None)),
        "krope": ParamInfo((batch, max_len, cfg.qk_rope_dim), cfg.dtype,
                           ("batch", "kv_seq", None)),
    }


def _rms(x, scale, eps):
    """The reference's MLA norm: f32 RMS, scaled by ``1 + scale``."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(torch.square(x32), -1, keepdim=True)
                          + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _softmax_rows(logits, mask, dt):
    """Softmax over the last axis in the logits' dtype with hidden entries
    at -1e30 (-3e4 in bf16), the probabilities in the activation dtype."""
    hidden = -3e4 if logits.dtype == torch.bfloat16 else -1e30
    return torch.softmax(torch.where(mask, logits, hidden), dim=-1).to(dt)


def _blocked_block(q, k, v, q0: int, scale: float, softcap: float = 0.0,
                   acc: torch.dtype = torch.float32):
    """One block of query rows ``q0 ...`` against keys ``0 .. q0 + rows``
    (causal): q [B,Sb,H,Dqk], k [B,Sk,H,Dqk], v [B,Sk,H,Dv].  Logits in
    ``acc``, capped at ``softcap * tanh(s / softcap)`` where ``softcap`` >
    0, as the reference's ``_sdpa_blocked`` body does."""
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(acc) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = q0 + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    probs = _softmax_rows(logits, kpos[None, :] <= qpos[:, None], q.dtype)
    return torch.einsum("bhqs,bshv->bqhv", probs, v)


def _attend_blocked(q, k, v, scale: float, q_block: int = Q_BLOCK, *,
                    softcap: float = 0.0, acc: torch.dtype = torch.float32):
    """Causal attention over blocks of ``q_block`` query rows, each block
    under a non-reentrant checkpoint (the reference's ``_sdpa_blocked``
    with its inner ``jax.checkpoint``): the ``[Sq,Skv]`` logits never exist
    at once, and the backward recomputes each block."""
    # The reference pins q, k and v's layouts across its scan (and each
    # block's output) so that no block re-shards them.
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    outs = []
    for q0 in range(0, q.shape[1], q_block):
        q1 = min(q.shape[1], q0 + q_block)
        outs.append(shard(checkpoint(
            _blocked_block, q[:, q0:q1], k[:, :q1], v[:, :q1], q0, scale,
            softcap, acc, use_reentrant=False), "batch", None, "heads", None))
    return torch.cat(outs, dim=1)


def _attend_dense(q_nope, k_nope, q_rope, k_rope, v, *, scale: float, dt):
    """Causal attention below the blocked threshold: the latent and RoPE
    logits summed, an f32 softmax, probabilities in ``dt``."""
    s = q_nope.shape[1]
    logits = (torch.einsum("bqhn,bshn->bhqs", q_nope, k_nope)
              + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope))
    pos_q = torch.arange(s, device=q_nope.device)
    probs = _softmax_rows(logits.float() * scale,
                          pos_q[None, :] <= pos_q[:, None], dt)
    return torch.einsum("bhqs,bshv->bqhv", probs, v)


def _attend_absorbed(q_nope, q_rope, ckv_all, kr_all, visible, wk_b, wv_b,
                     *, scale: float, dt):
    """Decode attention over the latent cache, wk_b absorbed into the
    query (q_lat[b,q,h,k] = q_nope . wk_b^T) and wv_b applied to the
    attended latents; ``visible`` [B or 1, L] masks the cache's rows."""
    q_lat = _einsum_w("bqhn,khn->bqhk", q_nope, wk_b, dt)
    logits = (torch.einsum("bqhk,bsk->bhqs", q_lat, ckv_all)
              + torch.einsum("bqhr,bsr->bhqs", q_rope, kr_all))
    probs = _softmax_rows(logits.float() * scale,
                          visible[:, None, None, :], dt)
    o_lat = torch.einsum("bhqs,bsk->bqhk", probs, ckv_all)
    return _einsum_w("bqhk,khv->bqhv", o_lat, wv_b, dt)


def _einsum_w(spec: str, x, w, dt):
    return torch.einsum(spec, x, w.to(dt))


def mla_apply(cfg: ModelConfig, p, x, *, positions,
              cache: Optional[dict] = None):
    """x [B,S,d] -> (y [B,S,d], new_cache).

    Train (cache None): full causal attention over the expanded heads.
    Decode (cache with ckv [B,L,kv_lora], krope [B,L,rope], pos): x is
    [B,1,d]; ``pos`` is one shared clock (a scalar) or one per slot
    (``[B]``).  Each slot writes its latent and RoPE key at its position
    (in place) and attends over the rows up to it.  A shared clock at or
    past L writes row L-1 (JAX's ``dynamic_update_slice`` clamps); a slot
    whose clock is at or past L writes nothing (JAX drops the scatter).
    """
    dt = adtype(cfg)
    b, s, _ = x.shape
    nope, kl = cfg.qk_nope_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)

    # --- queries ---
    if is_dtensor(x):
        # Under a mesh each device projects its own rows onto both latents
        # (replicated weights), which are then gathered for the heads'
        # projections (split over the heads).
        cq = shard(rows_matmul(x, p["wq_a"].to(dt)), "batch", None, None)
        kv_a = shard(rows_matmul(x, p["wkv_a"].to(dt)), "batch", None, None)
    else:
        cq = _einsum_w("bsd,dq->bsq", x, p["wq_a"], dt)
        kv_a = _einsum_w("bsd,dk->bsk", x, p["wkv_a"], dt)
    cq = _rms(cq, p["q_norm"], cfg.norm_eps)
    q = _einsum_w("bsq,qhk->bshk", cq, p["wq_b"], dt)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    q_nope = shard(q_nope, "batch", None, "heads", None)

    # --- KV latent ---
    ckv = _rms(kv_a[..., :kl], p["kv_norm"], cfg.norm_eps)
    k_rope_new = rope(kv_a[..., kl:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    if cache is None:
        k_nope = shard(_einsum_w("bsk,khn->bshn", ckv, p["wk_b"], dt),
                       "batch", None, "heads", None)
        v = shard(_einsum_w("bsk,khv->bshv", ckv, p["wv_b"], dt),
                  "batch", None, "heads", None)
        if s >= BLOCKED_ATTN_THRESHOLD:
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            k_full = torch.cat([k_nope, k_rope_new[:, :, None, :].expand(
                *k_nope.shape[:3], k_rope_new.shape[-1])], dim=-1)
            # The reference caps MLA's logits on this path only (its dense
            # and decode paths do not): so does the port.
            acc = torch.float32 if cfg.softmax_f32 else torch.bfloat16
            attend = partial(_attend_blocked, scale=scale,
                             softcap=cfg.logit_softcap, acc=acc)
            args = (q_full, k_full, v)
        else:
            attend = partial(_attend_dense, scale=scale, dt=dt)
            args = (q_nope, k_nope, q_rope, k_rope_new, v)
        if is_dtensor(q_nope):   # under a mesh: each device its rows, heads
            head = ("batch", None, "heads", None)
            axes = [head if a.dim() == 4 else ("batch", None, None)
                    for a in args]
            out = local_by_axes(attend, args, axes,
                                [(head, (*q_nope.shape[:3], v.shape[-1]))])
        else:
            out = attend(*args)
    else:
        pos = cache["pos"]
        if pos.dim() > 1 or s != 1:
            raise ValueError("decode takes one token per slot and a scalar "
                             "or [B] position clock")
        ckv_all, kr_all = cache["ckv"], cache["krope"]
        length = ckv_all.shape[1]
        if is_dtensor(ckv_all):
            at = pos.clamp(max=length - 1)
            keep = None if pos.dim() == 0 else pos < length
            ckv_all = write_rows(ckv_all, at.expand(b), ckv[:, 0], keep)
            kr_all = write_rows(kr_all, at.expand(b), k_rope_new[:, 0], keep)
            visible = (torch.arange(length, device=x.device)[None, :]
                       <= pos.reshape(-1, 1))
        elif pos.dim() == 0:
            at = pos.clamp(max=length - 1)
            ckv_all[:, at] = ckv[:, 0]
            kr_all[:, at] = k_rope_new[:, 0]
            visible = torch.arange(length, device=x.device)[None, :] <= pos
        else:
            rows = torch.arange(b, device=x.device)
            keep = (pos < length)[:, None]
            at = pos.clamp(max=length - 1)
            ckv_all[rows, at] = torch.where(keep, ckv[:, 0],
                                            ckv_all[rows, at])
            kr_all[rows, at] = torch.where(keep, k_rope_new[:, 0],
                                           kr_all[rows, at])
            visible = (torch.arange(length, device=x.device)[None, :]
                       <= pos[:, None])
        new_cache = {"ckv": ckv_all, "krope": kr_all, "pos": pos + 1}
        absorbed = partial(_attend_absorbed, scale=scale, dt=dt)
        args = (q_nope, q_rope, ckv_all, kr_all, visible, p["wk_b"],
                p["wv_b"])
        if is_dtensor(ckv_all):
            # Under a mesh each device attends for its rows and heads, over
            # its rows' whole cache (gathered where the mesh splits the
            # cache's sequence, as the flash op's strategies gather it).
            head, rows = ("batch", None, "heads", None), ("batch", None,
                                                          None)
            out = local_by_axes(
                absorbed, args, [head, head, rows, rows, ("batch", None),
                                 (None, "heads", None), (None, "heads",
                                                         None)],
                [(head, (*q_nope.shape[:3], p["wv_b"].shape[-1]))])
        else:
            out = absorbed(*args)

    y = _einsum_w("bqhv,hvd->bqd", out, p["wo"], dt)
    return shard(y, "batch", None, "embed"), new_cache
