"""Model-layout adapters over the kernels: causal attention (with an
optional sliding window and per-row ``kv_len``), cross attention (no mask),
the MoE expert FFN's grouped GEMM and the RWKV6 recurrence.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain version (the wrapper decides by device, and nothing else does).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.sharding import is_dtensor, local_by_axes
from .flash_attention import flash_attention
from .moe_gemm import moe_gemm
from .rwkv6_chunk import rwkv6_chunk


def attention(q_bshd, k_bskd, v_bskd, *, window: int = 0,
              kv_len: Optional[torch.Tensor] = None,
              softcap: float = 0.0) -> torch.Tensor:
    """Causal attention in the model layout [B,S,H,D]; returns [B,S,H,D].

    ``window`` > 0: sliding window of that many keys.  ``kv_len`` (int32
    [B]): row ``b`` sees only its first ``kv_len[b]`` keys (per-slot decode
    against a shared-length cache).  ``softcap`` > 0: each scaled logit s
    becomes ``softcap * tanh(s / softcap)``.
    """
    q = q_bshd.transpose(1, 2).contiguous()
    k = k_bskd.transpose(1, 2).contiguous()
    v = v_bskd.transpose(1, 2).contiguous()
    return flash_attention(q, k, v, causal=True, window=window,
                           kv_len=kv_len, **_cap(softcap)).transpose(1, 2)


def cross_attention(q_bshd, k_bskd, v_bskd, *,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention with no mask in the model layout: q [B,Sq,H,D] against
    k/v [B,Skv,KV,D] of another stream (Skv need not equal Sq); returns
    [B,Sq,H,D].  ``softcap`` as in :func:`attention`."""
    q = q_bshd.transpose(1, 2).contiguous()
    k = k_bskd.transpose(1, 2).contiguous()
    v = v_bskd.transpose(1, 2).contiguous()
    return flash_attention(q, k, v, causal=False,
                           **_cap(softcap)).transpose(1, 2)


def _cap(softcap: float) -> dict:
    """The soft cap as a keyword, only where there is one: an uncapped
    call is the call it was before the cap existed."""
    return {"softcap": softcap} if softcap else {}


def expert_ffn(buf_becd, w_edf) -> torch.Tensor:
    """One expert matmul over dispatch buffers: [B,E,C,d] @ [E,d,F] ->
    [B,E,C,F].

    The batch folds into capacity, ``[B,E,C,d] -> [E,B*C,d]``, so one
    grouped GEMM serves every row; each row keeps its own capacity slots,
    so rows never mix.
    """
    b, e, c, d = buf_becd.shape
    x = buf_becd.transpose(0, 1).contiguous().reshape(e, b * c, d)
    y = moe_gemm(x, w_edf)
    return y.reshape(e, b, c, -1).transpose(0, 1)


def rwkv_mix(r_bshd, k_bshd, v_bshd, wlog_bshd, u_hd) -> torch.Tensor:
    """The RWKV6 recurrence in the model layout: r, k, v, w_log [B,S,H,D],
    u [H,D] -> f32 [B,S,H,D].

    Heads fold into the batch, ``[B,S,H,D] -> [B*H,S,D]``; ``u`` is
    broadcast to ``[B*H,D]`` with ``expand``, so autograd sums its gradient
    over the batch.
    """
    b, s, h, d = r_bshd.shape
    if is_dtensor(r_bshd):     # under a mesh: each device its rows and heads
        head = ("batch", None, "heads", None)
        return local_by_axes(rwkv_mix, (r_bshd, k_bshd, v_bshd, wlog_bshd,
                                        u_hd), [head] * 4 + [("heads", None)],
                             [(head, r_bshd.shape)])

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    u = u_hd.float()[None].expand(b, h, d).reshape(b * h, d).contiguous()
    out = rwkv6_chunk(to_bh(r_bshd), to_bh(k_bshd), to_bh(v_bshd),
                      to_bh(wlog_bshd), u)
    return out.reshape(b, h, s, d).transpose(1, 2)
