"""Model-layout adapters over the kernels.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain version (the wrapper decides by device, and nothing else does).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def attention(q_bshd, k_bskd, v_bskd, *,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention in the model layout [B,S,H,D]; returns [B,S,H,D].

    ``kv_len`` (int32 [B]): row ``b`` sees only its first ``kv_len[b]`` keys
    (per-slot decode against a shared-length cache).
    """
    q = q_bshd.transpose(1, 2).contiguous()
    k = k_bskd.transpose(1, 2).contiguous()
    v = v_bskd.transpose(1, 2).contiguous()
    return flash_attention(q, k, v, causal=True,
                           kv_len=kv_len).transpose(1, 2)
