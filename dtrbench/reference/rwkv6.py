"""Plain float32 reference of RWKV-6 "Finch" (arXiv:2404.05892) as the
configuration runs it: pre-norm blocks of time-mix (token shift, the
receptance, key, value and gate projections, the data-dependent decay
w = exp(-exp(clip(w0 + tanh(x A) B, -8, 4))), the WKV recurrence with the
bonus u, a per-head RMS norm, the output projection) and channel-mix
(token shift, sigmoid receptance, squared-ReLU key), untied embeddings.

The recurrence, per head with state S [D_k, D_v]:
``out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``,
``S_t = diag(w_t) S_{t-1} + k_t^T v_t``; here it runs in chunks of 32
steps with every decay factor a product over the chunk's own steps (each
<= 1, so no exponent overflows), and the layer is recomputed in the
backward (``torch.utils.checkpoint``) to keep one row's activations small.

Departures from the published model, as the configuration states them:
RMS norms with a ``1 + scale`` gain where Finch has LayerNorms with
biases; the token shift mixes by a static ``mu`` (Finch adds a
data-dependent LoRA to it); the head norm is an RMS norm (eps 1e-5) with a
``1 + ln_x`` gain.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Leaf, nll, rms

FAULT_LEAF = "embed.unembed"
LORA = 64
CHUNK = 32


def layout(model: dict) -> list:
    d, f, v, n = (model[k] for k in ("d_model", "d_ff", "vocab", "n_layers"))
    dh = model["rwkv_head_dim"]
    h = d // dh
    g = "groups.slot0."
    # The residual branches' output projections start at 1/sqrt(2 n) of
    # the fan-in scale (GPT-2's rule), so the stream stays O(1) with depth.
    out = (2 * n) ** -0.5
    stack = [
        ("mix.mu", (5, d), 0.5, 0.1), ("mix.mu_c", (2, d), 0.5, 0.1),
        ("mix.w0", (d,), -2.0, 0.5),
        ("mix.wA", (d, LORA), 0.0, d ** -0.5),
        ("mix.wB", (LORA, d), 0.0, 0.01),
        ("mix.u", (h, dh), 0.0, 0.3),
        ("mix.wr", (d, d), 0.0, d ** -0.5), ("mix.wk", (d, d), 0.0, d ** -0.5),
        ("mix.wv", (d, d), 0.0, d ** -0.5), ("mix.wg", (d, d), 0.0, d ** -0.5),
        ("mix.wout", (d, d), 0.0, d ** -0.5 * out),
        ("mix.ln_x", (d,), 0.0, 0.0),
        ("mix.wr_c", (d, d), 0.0, d ** -0.5),
        ("mix.wk_c", (d, f), 0.0, d ** -0.5),
        ("mix.wv_c", (f, d), 0.0, f ** -0.5 * out),
        ("norm1.scale", (d,), 0.0, 0.0), ("norm2.scale", (d,), 0.0, 0.0),
    ]
    leaves = [Leaf("embed.tokens", (v, d), std=1.0),
              Leaf("embed.unembed", (d, v), std=d ** -0.5),
              Leaf("final_norm.scale", (d,))]
    leaves += [Leaf(g + name, (n, *shape), mean=mean, std=std, stacked=True)
               for name, shape, mean, std in stack]
    return sorted(leaves, key=lambda leaf: leaf.name)


def wkv(r, k, v, logw, u):
    """The recurrence over a row: r, k, v, logw [B,S,H,D] f32 (logw <= 0),
    u [H,D] -> [B,S,H,D] f32, from a zero state."""
    b, s, h, d = r.shape
    n, c = s // CHUNK, CHUNK

    def chunks(x):                                     # [B,H,n,C,D]
        return x.transpose(1, 2).reshape(b, h, n, c, d)

    r, k, v, w = (chunks(x) for x in (r, k, v, logw))
    a = torch.cumsum(w, dim=3)               # decay through step t, inclusive
    a_prev = a - w                           # through step t - 1
    # Within a chunk: query t reads key j < t through the decays j+1..t-1.
    causal = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    gap = (a_prev[..., :, None, :] - a[..., None, :, :]).masked_fill(
        ~causal[:, :, None], float("-inf"))
    scores = (r[..., :, None, :] * k[..., None, :, :] * torch.exp(gap)).sum(-1)
    out = scores @ v + (r * u[None, :, None, None, :] * k).sum(
        -1, keepdim=True) * v
    # Across chunks: the state entering each chunk.
    r_in = r * torch.exp(a_prev)
    k_out = k * torch.exp(a[..., -1:, :] - a)
    decay = torch.exp(a[..., -1, :])                   # [B,H,n,D]
    state = r.new_zeros(b, h, d, d)
    carried = []
    for i in range(n):
        carried.append(r_in[:, :, i] @ state)
        state = decay[:, :, i, :, None] * state \
            + k_out[:, :, i].transpose(-1, -2) @ v[:, :, i]
    out = out + torch.stack(carried, dim=2)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _block(x, p: dict, i: int, model: dict, num):
    g = "groups.slot0."
    d, dh = model["d_model"], model["rwkv_head_dim"]
    b, s = x.shape[:2]
    eps = model["norm_eps"]
    hn = rms(x, p[g + "norm1.scale"][i], eps)
    xs = _shift(hn)
    mu = p[g + "mix.mu"][i]
    xr, xk, xv, xw, xg = (hn + (xs - hn) * mu[j] for j in range(5))
    heads = (b, s, d // dh, dh)
    r = num.act(num.mm(xr, p[g + "mix.wr"][i]).view(heads))
    k = num.act(num.mm(xk, p[g + "mix.wk"][i]).view(heads))
    v = num.act(num.mm(xv, p[g + "mix.wv"][i]).view(heads))
    gate = F.silu(num.mm(xg, p[g + "mix.wg"][i]))
    lora = num.mm(torch.tanh(num.mm(xw, p[g + "mix.wA"][i])),
                  p[g + "mix.wB"][i])
    logw = -torch.exp(torch.clamp(p[g + "mix.w0"][i] + lora, -8.0, 4.0))
    out = wkv(r, k, v, logw.view(heads), p[g + "mix.u"][i])
    y = out * torch.rsqrt(torch.mean(out * out, dim=-1, keepdim=True) + 1e-5)
    y = y.reshape(b, s, d) * (1.0 + p[g + "mix.ln_x"][i]) * gate
    x = x + num.mm(y, p[g + "mix.wout"][i])
    h2 = rms(x, p[g + "norm2.scale"][i], eps)
    xs2 = _shift(h2)
    mu_c = p[g + "mix.mu_c"][i]
    xk2, xr2 = h2 + (xs2 - h2) * mu_c[0], h2 + (xs2 - h2) * mu_c[1]
    rc = torch.sigmoid(num.mm(xr2, p[g + "mix.wr_c"][i]))
    kc = torch.square(torch.relu(num.mm(xk2, p[g + "mix.wk_c"][i])))
    return x + rc * num.mm(kc, p[g + "mix.wv_c"][i])


def row_loss(p: dict, tokens, model: dict, num):
    """The mean next-token loss of one row of tokens [1,S]."""
    x = F.embedding(tokens, p["embed.tokens"])
    for i in range(model["n_layers"]):
        x = checkpoint(_block, x, p, i, model, num, use_reentrant=False)
    x = rms(x, p["final_norm.scale"], model["norm_eps"])
    return nll(num.mm(x, p["embed.unembed"]), tokens)


def forward_flops(model: dict, batch: int, seq: int) -> float:
    """Matrix-product FLOPs of one forward over ``batch`` rows of ``seq``:
    the five d x d projections, the decay LoRA, the channel-mix's three
    products, the unembedding and the recurrence's r.S and state update
    (4 D^2 a head and token).  Recompute is not counted."""
    d, f, v = model["d_model"], model["d_ff"], model["vocab"]
    dh = model["rwkv_head_dim"]
    tokens = batch * seq
    per_token = 2 * (5 * d * d + 2 * d * LORA + d * d + 2 * d * f) \
        + 4 * dh * dh * (d // dh)
    return model["n_layers"] * tokens * per_token + tokens * 2 * d * v
