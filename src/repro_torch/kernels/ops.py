"""Model-layout adapters over the kernels: causal attention (with an
optional sliding window and per-row ``kv_len``), cross attention (no mask),
decode attention over a sequence-sharded KV cache (each device's keys,
merged by log-sum-exp), the MoE expert FFN's grouped GEMM and the RWKV6
recurrence.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain version (the wrapper decides by device, and nothing else does).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.sharding import (entry_dims, is_dtensor, local_by_axes,
                                    mesh_index, placements, pspec)
from .flash_attention import flash_attention, flash_attention_lse
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


def attention_lse(q_bshd, k_bskd, v_bskd, *, kv_len: torch.Tensor,
                  softcap: float = 0.0):
    """:func:`attention` at decode with each row's log-sum-exp and no
    autograd: ``(out [B,S,H,D], lse f32 [B,S,H])``
    (``flash_attention_lse``)."""
    q = q_bshd.transpose(1, 2).contiguous()
    k = k_bskd.transpose(1, 2).contiguous()
    v = v_bskd.transpose(1, 2).contiguous()
    out, lse = flash_attention_lse(q, k, v, causal=True, kv_len=kv_len,
                                   **_cap(softcap))
    return out.transpose(1, 2), lse.transpose(1, 2)


def merge_attention(o, lse):
    """Attention over keys cut into N shards, from each shard's own: ``o``
    [N, ..., D] and its rows' log-sum-exp ``lse`` (f32 [N, ...]) stacked on
    dim 0 -> ``(out [..., D] in o's dtype, lse f32 [...])``.

    Each shard weighs exp(lse - m), m the rows' largest: out = sum w o /
    sum w, in f32.  A shard whose row saw no key weighs exactly 0 beside
    one that saw a key, whether it says so with the kernel's -inf or the
    plain version's -1e30 (its o is finite either way, so 0 never meets a
    NaN); m is clamped at -1e30, so a row no shard saw gives 0 (the
    kernel's shards) or the plain version's mean(V), never NaN.  The same
    code runs on plain tensors and on DTensors whose dim 0 is laid out
    over the cache's sequence dims, where the max and the sums are
    all-reduces."""
    m = lse.amax(0).clamp(min=-1e30)
    w = torch.exp(lse - m.unsqueeze(0))
    den = w.sum(0)
    num = (w.unsqueeze(-1) * o.float()).sum(0)
    out = num / den.clamp(min=1e-20).unsqueeze(-1)
    return out.to(o.dtype), m + torch.log(den)


def shard_kv_len(kv_len, r: int, n: int) -> torch.Tensor:
    """The keys a shard sees: rows ``r n .. (r + 1) n`` of a cache whose
    slot b sees its first ``kv_len[b]`` rows -> int32
    ``clamp(kv_len - r n, 0, n)``."""
    return (kv_len - r * n).clamp(0, n).to(torch.int32)


def split_kv_attention(q_bshd, k_bskd, v_bskd, *, kv_len,
                       softcap: float = 0.0):
    """Decode attention over a DTensor KV cache whose sequence is laid out
    over mesh dims (the ``kv_seq`` rule; context parallelism), as
    :func:`attention` with ``kv_len`` computes it on one device: q
    [B,1,H,D], k/v [B,L,KV,D], kv_len int32 [B] -> [B,1,H,D]; None where
    the cache is a plain tensor or its sequence is whole on every device
    (the caller then takes :func:`attention`).

    Each device attends only its own rows of the cache: q (one token a
    slot) is replicated over the sequence's dims, and device r over them
    (its index in mesh order, major first, as the cache's rows are laid
    out) holds rows r L_l .. (r + 1) L_l and sees the first clamp(kv_len
    - r L_l, 0, L_l) of them.  One ``local_map`` runs the flash op with
    the LSE there (the soft cap inside it); its outputs come out stacked
    on a leading dim laid out over the sequence's dims, and
    :func:`merge_attention` merges them in DTensor ops (a max and two
    sums reduced over those dims).  A ring cache (a windowed layer's) is
    split alike: softmax does not depend on the order of the keys.
    """
    if not is_dtensor(k_bskd):
        return None
    spec = pspec("batch", "kv_seq", "kv_heads", None,
                 shape=tuple(k_bskd.shape))
    by_seq = entry_dims(spec[1]) if spec else ()
    if not by_seq:
        return None
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_bskd.device_mesh
    kv_pl = placements(spec, mesh)

    def like(dims):
        """Placements of a tensor whose dim ``dims[i]`` is the cache's dim
        i (the others replicated)."""
        return [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                else Replicate() for p in kv_pl]

    q_pl, len_pl = like({0: 0, 2: 2}), like({0: 0})
    o_pl = like({1: 0, 0: 1, 2: 3})          # [N, B, 1, H, (D)]

    def local(q, k, v, kv_len):
        out, lse = attention_lse(q, k, v, kv_len=shard_kv_len(
            kv_len, mesh_index(mesh, by_seq), k.shape[1]), softcap=softcap)
        return out[None], lse[None]

    o, lse = local_map(local, out_placements=(o_pl, o_pl),
                       in_placements=(q_pl, kv_pl, kv_pl, len_pl),
                       device_mesh=mesh, redistribute_inputs=True)(
        q_bshd, k_bskd, v_bskd, kv_len)
    return merge_attention(o, lse)[0]


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
