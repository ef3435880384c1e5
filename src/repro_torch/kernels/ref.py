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


def moe_gemm_reference(x, w) -> torch.Tensor:
    """x: [E,C,d]; w: [E,d,F] -> [E,C,F] — per-expert matmul in f32, the
    result in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rwkv6_reference(r, k, v, w_log, u) -> torch.Tensor:
    """Serial WKV6 recurrence.  r, k, v, w_log: [BH,S,D]; u: [BH,D].

    Per b*h, from a zero f32 state S: out_t = r_t (S + u k_t v_t^T), then
    S = diag(exp(w_log_t)) S + k_t v_t^T.  Inputs are widened to f32; the
    result is f32 [BH,S,D].  Autograd through it is the plain version of the
    backward kernel.
    """
    r, k, v, u = r.float(), k.float(), v.float(), u.float()
    w = torch.exp(w_log.float())
    bh, s, d = r.shape
    state = r.new_zeros(bh, d, d)
    outs = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bd,bde->be", r[:, t],
                                 state + u[:, :, None] * kv))
        state = state * w[:, t, :, None] + kv
    return torch.stack(outs, dim=1)


def rwkv6_backward_reference(r, k, v, w_log, u, g):
    """Gradients of ``rwkv6_reference`` against the output gradient ``g``
    (f32 [BH,S,D]), by autograd: ``(gr, gk, gv, gw_log, gu)`` in the
    inputs' dtypes."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (r, k, v, w_log, u)]
        out = rwkv6_reference(*xs)
        # At S = 1 the decay never reaches the output: its gradient is 0.
        return torch.autograd.grad(out, xs, g, allow_unused=True,
                                   materialize_grads=True)
