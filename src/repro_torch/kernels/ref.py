"""Plain PyTorch versions of the kernels (the correctness contract)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_reference(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k/v: [B,Hkv,Skv,D] — naive softmax attention.

    ``kv_len`` (int [B], optional): row ``b`` attends over its first
    ``kv_len[b]`` keys with causal offset ``kv_len[b] - Sq``, as if k and v
    were cut to that length.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(d)
    length = (torch.full((b,), skv, device=q.device) if kv_len is None
              else kv_len.to(q.device).clamp(0, skv))[:, None, None]
    qpos = torch.arange(sq, device=q.device)[None, :, None] + (length - sq)
    kpos = torch.arange(skv, device=q.device)[None, None, :]
    mask = kpos < length                       # [B, Sq or 1, Skv]
    if causal:
        mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & ((qpos - kpos) < window)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)
