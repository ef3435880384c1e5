"""Plain float32 reference of Mixtral-8x7B (arXiv:2401.04088) as the
configuration runs it: pre-norm blocks of grouped-query attention with
rotary positions (the half-split rotation, theta from the file) and a
sliding window, then a sparse MoE FFN (softmax router, top-2, the two
weights renormalised, SwiGLU experts), untied embeddings.

Departures from the published model, as the configuration states them:
the RMS norms scale by ``1 + scale`` (scales start at 0); each expert holds
at most C = ceil(S * k / E * capacity_factor) rounded up to 8 assignments
of a row, taken in (token, k) order, and an expert that receives more than
C also loses its C-th (the last slot of an overflowing expert's buffer is
emptied, as the reference package's scatter does); the published model
drops nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import Leaf, nll, rms

# The leaf the planted "answer altered" fault doubles.
FAULT_LEAF = "groups.slot0.attn.wq"
# Leaves trained as one autograd leaf per (layer, expert).
SPLIT = {f"groups.slot0.ffn.{w}": 2 for w in ("wi", "wg", "wo")}


def layout(model: dict) -> list:
    d, h, kv, hd = (model[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                        "head_dim"))
    e, f, v, n = (model[k] for k in ("n_experts", "moe_d_ff", "vocab",
                                      "n_layers"))
    g = "groups.slot0."
    # The residual branches' output projections start at 1/sqrt(2 n) of
    # the fan-in scale (GPT-2's rule), so the stream stays O(1) with depth.
    out = (2 * n) ** -0.5
    leaves = [
        Leaf("embed.tokens", (v, d), std=1.0),
        Leaf("embed.unembed", (d, v), std=d ** -0.5),
        Leaf("final_norm.scale", (d,)),
        Leaf(g + "attn.wq", (n, d, h, hd), std=d ** -0.5, stacked=True),
        Leaf(g + "attn.wk", (n, d, kv, hd), std=d ** -0.5, stacked=True),
        Leaf(g + "attn.wv", (n, d, kv, hd), std=d ** -0.5, stacked=True),
        Leaf(g + "attn.wo", (n, h, hd, d), std=(h * hd) ** -0.5 * out,
             stacked=True),
        Leaf(g + "ffn.router", (n, d, e), std=d ** -0.5, stacked=True),
        Leaf(g + "ffn.wi", (n, e, d, f), std=d ** -0.5, stacked=True),
        Leaf(g + "ffn.wg", (n, e, d, f), std=d ** -0.5, stacked=True),
        Leaf(g + "ffn.wo", (n, e, f, d), std=f ** -0.5 * out, stacked=True),
        Leaf(g + "norm1.scale", (n, d), stacked=True),
        Leaf(g + "norm2.scale", (n, d), stacked=True),
    ]
    return sorted(leaves, key=lambda leaf: leaf.name)


def capacity(model: dict, seq: int) -> int:
    c = math.ceil(seq * model["top_k"] / model["n_experts"]
                  * model["capacity_factor"])
    return max(8, math.ceil(c / 8) * 8)


def rope(x, theta: float):
    """x [1,S,H,D]: the half-split rotation at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ).to(x.device)
    ang = torch.arange(s, device=x.device).float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, num):
    """Causal softmax attention of one row: q [1,S,H,D], k/v [1,S,KV,D];
    query head h reads kv head h // (H / KV); a key j is visible to query
    i when j <= i and, with a window, i - j < window."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    qh = q[0].transpose(0, 1)                                 # [H,S,D]
    kh = k[0].transpose(0, 1).repeat_interleave(rep, dim=0)
    vh = v[0].transpose(0, 1).repeat_interleave(rep, dim=0)
    logits = num.mm(qh, kh.transpose(1, 2)) / math.sqrt(d)
    i = torch.arange(s, device=q.device)
    seen = i[None, :] <= i[:, None]
    if window:
        seen &= (i[:, None] - i[None, :]) < window
    probs = torch.softmax(logits.masked_fill(~seen, float("-inf")), dim=-1)
    return num.mm(probs, vh).transpose(0, 1)[None]            # [1,S,H,D]


def moe(x, router, wi, wg, wo, model: dict, num):
    """The routed experts of one row x [1,S,d]."""
    s = x.shape[1]
    e, k = model["n_experts"], model["top_k"]
    cap = capacity(model, s)
    scores = torch.softmax(x[0] @ router, dim=-1)             # [S,E] f32
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = topi.reshape(-1)                                 # (token, k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.numel(), device=x.device) - start[sorted_e]
    keep = (rank < cap) & ~((counts[sorted_e] > cap) & (rank == cap - 1))
    weight = topw.reshape(-1)
    out = torch.zeros_like(x[0])
    for ex in range(e):
        idx = order[keep & (sorted_e == ex)]
        if idx.numel() == 0:
            continue
        tok = idx // k
        xe = x[0, tok]
        y = num.mm(F.silu(num.mm(xe, wg[ex])) * num.mm(xe, wi[ex]), wo[ex])
        out = out.index_add(0, tok, y * weight[idx, None])
    return out[None]


def row_loss(p: dict, tokens, model: dict, num):
    """The mean next-token loss of one row of tokens [1,S]."""
    d, h, kv, hd = (model[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                        "head_dim"))
    eps, theta = model["norm_eps"], model["rope_theta"]
    window = model.get("window", 0)
    g = "groups.slot0."
    x = F.embedding(tokens, p["embed.tokens"])
    s = x.shape[1]
    for i in range(model["n_layers"]):
        hn = rms(x, p[g + "norm1.scale"][i], eps)
        q = num.mm(hn, p[g + "attn.wq"][i].reshape(d, h * hd)).view(
            1, s, h, hd)
        kk = num.mm(hn, p[g + "attn.wk"][i].reshape(d, kv * hd)).view(
            1, s, kv, hd)
        vv = num.mm(hn, p[g + "attn.wv"][i].reshape(d, kv * hd)).view(
            1, s, kv, hd)
        a = attention(rope(q, theta), rope(kk, theta), vv, window, num)
        x = x + num.mm(a.reshape(1, s, h * hd),
                       p[g + "attn.wo"][i].reshape(h * hd, d))
        h2 = rms(x, p[g + "norm2.scale"][i], eps)
        x = x + moe(h2, p[g + "ffn.router"][i], p[g + "ffn.wi"][i],
                    p[g + "ffn.wg"][i], p[g + "ffn.wo"][i], model, num)
    x = rms(x, p["final_norm.scale"], eps)
    return nll(num.mm(x, p["embed.unembed"]), tokens)


def forward_flops(model: dict, batch: int, seq: int) -> float:
    """Matrix-product FLOPs of one forward over ``batch`` rows of ``seq``:
    the projections, the router, the top-k experts each token is routed to,
    the unembedding, and q.k and p.v over the visible causal pairs.
    Recompute is not counted."""
    d, h, kv, hd = (model[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                        "head_dim"))
    e, k, f, v = (model[x] for x in ("n_experts", "top_k", "moe_d_ff",
                                      "vocab"))
    window = model.get("window", 0)
    tokens = batch * seq
    per_token = 2 * (d * (h + 2 * kv) * hd + h * hd * d + d * e
                     + k * 3 * d * f)
    pairs = batch * sum(min(i + 1, window or seq) for i in range(seq))
    layer = tokens * per_token + 4 * h * hd * pairs
    return model["n_layers"] * layer + tokens * 2 * d * v
