"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The counterpart of ``repro.models.rglru``.  Real-Gated Linear Recurrent
Unit:   h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)
with  a_t = exp(−c·softplus(Λ)·r_t),  r_t = σ(W_r x_t),  i_t = σ(W_i x_t).
The full block: in-proj → [branch1: causal temporal conv(4) → RG-LRU] ⊙
gelu(branch2) → out-proj.  The JAX package has no Pallas kernel here: its
recurrence is XLA's ``associative_scan``, so plain PyTorch is the port.

Training runs the recurrence as a log-depth scan over the sequence
(:func:`linear_scan`): ⌈log₂ S⌉ steps of elementwise products on (a, b)
pairs, differentiated by autograd.  It multiplies decays and never divides
by them: the closed form through ``exp(cumsum(log a))`` would underflow, as
log a_t reaches −8·softplus(Λ) a step.  Decode is one fused step carrying
``(h, conv_state)``, with ``h`` rounded to the activation dtype each step,
as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import adtype, gelu
from .params import ParamInfo

_C = 8.0  # Griffin's fixed recurrence sharpness


def rglru_defs(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    cw = cfg.conv_width
    return {
        "w_in1": ParamInfo((d, w), cfg.param_dtype, (None, "lru"),
                           fsdp_dim=0),
        "w_in2": ParamInfo((d, w), cfg.param_dtype, (None, "lru"),
                           fsdp_dim=0),
        "conv": ParamInfo((cw, w), cfg.param_dtype, ("conv", "lru")),
        "w_i": ParamInfo((w, w), cfg.param_dtype, (None, "lru"), fsdp_dim=0),
        "w_r": ParamInfo((w, w), cfg.param_dtype, (None, "lru"), fsdp_dim=0),
        "lam": ParamInfo((w,), cfg.param_dtype, ("lru",), init_scale=0.65),
        "w_out": ParamInfo((w, d), cfg.param_dtype, ("lru", None),
                           fsdp_dim=1),
    }


def rglru_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    w, cw = cfg.lru_width or cfg.d_model, cfg.conv_width
    return {
        "h": ParamInfo((batch, w), cfg.dtype, ("batch", "lru")),
        "conv": ParamInfo((batch, cw - 1, w), cfg.dtype,
                          ("batch", None, "lru")),
    }


def _gates(p, u):
    """The decay ``a`` and input ``b`` of each step, f32."""
    dt = u.dtype
    r = torch.sigmoid((u @ p["w_r"].to(dt)).float())
    i = torch.sigmoid((u @ p["w_i"].to(dt)).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, b


def _conv_full(p, u):
    """Causal temporal conv over [B,S,W] with kernel [CW,W], in u's
    dtype."""
    cw, s = p["conv"].shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    k = p["conv"].to(u.dtype)
    out = pad[:, 0:s] * k[0]
    for i in range(1, cw):
        out = out + pad[:, i:i + s] * k[i]
    return out


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1, as a log-depth
    (Hillis–Steele) scan: at offset o each step composes (a, b) with the
    pair o steps back, ``(a_t a_{t-o}, a_t b_{t-o} + b_t)``, so after
    ⌈log₂ S⌉ steps b_t is h_t.  Only products of decays in (0, 1] and sums
    of bounded terms: nothing overflows."""
    s, o = a.shape[1], 1
    while o < s:
        b = torch.cat([b[:, :o], a[:, o:] * b[:, :-o] + b[:, o:]], dim=1)
        if 2 * o < s:
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def rglru_apply(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None):
    """x: [B,S,d] (train) or [B,1,d] (decode with cache) -> (y, new_cache);
    new_cache is None without a cache."""
    dt = adtype(cfg)
    u1 = x @ p["w_in1"].to(dt)
    u2 = x @ p["w_in2"].to(dt)
    if cache is None:
        a, b = _gates(p, _conv_full(p, u1))
        h = linear_scan(a, b).to(dt)
        new_cache = None
    else:
        # Decode: shift the conv state, one recurrence step.
        window = torch.cat([cache["conv"], u1], dim=1)      # [B, CW, W]
        u1c = (window * p["conv"].to(dt)).sum(1)[:, None, :]
        a, b = _gates(p, u1c)
        h = (a[:, 0] * cache["h"].float() + b[:, 0]).to(dt)[:, None, :]
        new_cache = {"h": h[:, 0], "conv": window[:, 1:]}
    y = h * gelu(u2)
    return y @ p["w_out"].to(dt), new_cache
