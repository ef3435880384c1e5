"""Plain PyTorch versions of the kernels (the correctness contract)."""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

# Query rows from which the plain attention runs blocked: the reference's
# ``layers.BLOCKED_ATTN_THRESHOLD`` and ``_sdpa_blocked``'s block.
BLOCKED_ATTN_THRESHOLD = 2048
Q_BLOCK = 512


def _acc(x):
    """The dtype the plain attention computes in: f32, or f64 for f64
    inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _flash_logits(q, k, causal, window, kv_len, softcap=0.0):
    """Scaled logits [B,Hkv,G,Sq,Skv] (f32, or f64 for f64 inputs) with
    hidden pairs at -1e30; ``softcap`` > 0 caps each scaled logit s at
    ``softcap * tanh(s / softcap)`` before the mask, as the reference's
    ``_sdpa`` does."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.to(_acc(q)),
                          k.to(_acc(q))) / math.sqrt(d)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    length = (torch.full((b,), skv, device=q.device) if kv_len is None
              else kv_len.to(q.device).clamp(0, skv))[:, None, None]
    qpos = torch.arange(sq, device=q.device)[None, :, None] + (length - sq)
    kpos = torch.arange(skv, device=q.device)[None, None, :]
    mask = kpos < length                       # [B, Sq or 1, Skv]
    if causal:
        mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & ((qpos - kpos) < window)
    return torch.where(mask[:, None, None], logits, -1e30)


def flash_reference(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k/v: [B,Hkv,Skv,D] — naive softmax attention.

    ``kv_len`` (int [B], optional): row ``b`` attends over its first
    ``kv_len[b]`` keys with causal offset ``kv_len[b] - Sq``, as if k and v
    were cut to that length.  ``softcap``: see ``_flash_logits``.
    """
    b, hq, sq, d = q.shape
    probs = torch.softmax(_flash_logits(q, k, causal, window, kv_len,
                                        softcap), -1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(probs.dtype))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_reference_blocked(q, k, v, *, causal: bool = True,
                            window: int = 0, q_block: int = Q_BLOCK,
                            softcap: float = 0.0) -> torch.Tensor:
    """``flash_reference`` over blocks of ``q_block`` query rows, each under
    a non-reentrant ``torch.utils.checkpoint``, so the ``[Sq,Skv]`` logits
    never exist at once and the backward recomputes each block from q, k and
    v: the counterpart of the reference's ``_sdpa_blocked`` (its inner
    ``jax.checkpoint``).  A causal block sees only the keys up to its last
    row's position, so k and v are cut there."""
    sq, skv = q.shape[2], k.shape[2]
    block = partial(flash_reference, causal=causal, window=window,
                    softcap=softcap)
    outs = []
    for i0 in range(0, sq, q_block):
        i1 = min(sq, i0 + q_block)
        n = skv - sq + i1 if causal else skv
        outs.append(checkpoint(block, q[:, :, i0:i1], k[:, :, :n],
                               v[:, :, :n], use_reentrant=False))
    return torch.cat(outs, dim=2)


def flash_reference_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        softcap: float = 0.0):
    """``flash_reference``'s output and the f32 log-sum-exp of each row's
    scaled (and capped) logits, ``[B,Hq,Sq]`` (what the forward kernel
    saves for its backward)."""
    b, hq, sq, d = q.shape
    logits = _flash_logits(q, k, causal, window, kv_len, softcap)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(probs.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    return out.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def flash_backward_reference(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """Gradients of ``flash_reference`` against ``do`` from the forward's
    output ``o`` and row log-sum-exp ``lse`` (f32 ``[B,Hq,Sq]``), step by
    step as the backward kernel computes them, in f32:

      D  = rowsum(dO * O)              per query row
      P  = exp(S - lse)                S = Q K^T / sqrt(d), hidden pairs 0
      dV = sum_g P^T dO                over the G query heads of a KV head
      dS = P * (dO V^T - D)
      dQ = dS K / sqrt(d)
      dK = sum_g dS^T Q / sqrt(d)

    With ``softcap`` c > 0, S is the capped S' = c tanh(S / c) in P, and
    dS is multiplied by the cap's derivative 1 - (S' / c)^2.

    Returns ``(dq, dk, dv)`` in the inputs' dtypes.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)

    def grouped(x):
        return x.float().reshape(b, hkv, g, sq, -1)

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    delta = (dog * og).sum(-1, keepdim=True)            # [B,Hkv,G,Sq,1]
    s = _flash_logits(q, k, causal, window, None, softcap)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))     # hidden: exp(-1e30)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    ds = p * (dp - delta)
    if softcap > 0:   # hidden pairs (-1e30) clamp to -c: their dS is 0
        ds = ds * (1 - torch.square(s.clamp(min=-softcap) / softcap))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
