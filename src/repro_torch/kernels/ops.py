"""Model-layout adapters over the kernels: causal attention (with an
optional sliding window and per-row ``kv_len``) and the MoE expert FFN's
grouped GEMM.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain version (the wrapper decides by device, and nothing else does).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .moe_gemm import moe_gemm


def attention(q_bshd, k_bskd, v_bskd, *, window: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention in the model layout [B,S,H,D]; returns [B,S,H,D].

    ``window`` > 0: sliding window of that many keys.  ``kv_len`` (int32
    [B]): row ``b`` sees only its first ``kv_len[b]`` keys (per-slot decode
    against a shared-length cache).
    """
    q = q_bshd.transpose(1, 2).contiguous()
    k = k_bskd.transpose(1, 2).contiguous()
    v = v_bskd.transpose(1, 2).contiguous()
    return flash_attention(q, k, v, causal=True, window=window,
                           kv_len=kv_len).transpose(1, 2)


def expert_ffn(buf_becd, w_edf) -> torch.Tensor:
    """One expert matmul over dispatch buffers: [B,E,C,d] @ [E,d,F] ->
    [B,E,C,F].

    The batch folds into capacity, ``[B,E,C,d] -> [E,B*C,d]``, so one
    grouped GEMM serves every row; each row keeps its own capacity slots,
    so rows never mix.
    """
    b, e, c, d = buf_becd.shape
    x = buf_becd.transpose(0, 1).reshape(e, b * c, d).contiguous()
    y = moe_gemm(x, w_edf)
    return y.reshape(e, b, c, -1).transpose(0, 1)
