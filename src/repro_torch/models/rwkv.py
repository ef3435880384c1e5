"""RWKV6 ("Finch"): attention-free time-mix with data-dependent decay.

The counterpart of ``repro.models.rwkv`` on full sequences (training and
prefill-shaped forwards).  The WKV recurrence goes through
``kernels.ops.rwkv_mix``: the Hopper forward and backward kernels for CUDA
tensors, the plain serial scan for CPU tensors.  The JAX package computes
it in chunked form (``_chunked_wkv``) with the same result.

The dtype order is the reference's: projections and the decay LoRA in the
activation dtype, the LoRA then widened; the log-decay
``-exp(clip(w0 + lora, -8, 4))``, the bonus ``u`` and the head norm in f32.
Sequences must be a multiple of 16 long, as the reference's chunked form
requires.

Decode (``cache=`` given, one token a slot) is the reference's one-token
branch in plain PyTorch: the token shift takes the previous token from the
cache, and the recurrence updates the ``[B,H,D,D]`` f32 state once
(``out = r·(S + u⊙kᵀv)``, ``S ← S⊙w + kᵀv``); it reaches no WKV kernel.
With a cache each mix returns ``(y, new_cache)``, without one ``y``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_dtensor, local_by_axes, shard
from ..kernels import ops
from .config import ModelConfig
from .layers import adtype, rows_matmul
from .params import ParamInfo

_LORA = 64
_CHUNK = 16


def rwkv_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    pd = cfg.param_dtype
    return {
        # time-mix
        "mu": ParamInfo((5, d), pd, (None, None), init_scale=0.5),
        "w0": ParamInfo((d,), pd, (None,), init_scale=-0.6),
        "wA": ParamInfo((d, _LORA), pd, (None, None)),
        "wB": ParamInfo((_LORA, d), pd, (None, None)),
        "u": ParamInfo((h, dh), pd, ("heads", None), init_scale=0.3),
        "wr": ParamInfo((d, d), pd, (None, "heads"), fsdp_dim=0),
        "wk": ParamInfo((d, d), pd, (None, "heads"), fsdp_dim=0),
        "wv": ParamInfo((d, d), pd, (None, "heads"), fsdp_dim=0),
        "wg": ParamInfo((d, d), pd, (None, "heads"), fsdp_dim=0),
        "wout": ParamInfo((d, d), pd, ("heads", None), fsdp_dim=1),
        "ln_x": ParamInfo((d,), pd, (None,), init_scale=0.0),
        # channel-mix
        "mu_c": ParamInfo((2, d), pd, (None, None), init_scale=0.5),
        "wr_c": ParamInfo((d, d), pd, (None, None), fsdp_dim=0),
        "wk_c": ParamInfo((d, f), pd, (None, "mlp"), fsdp_dim=0),
        "wv_c": ParamInfo((f, d), pd, ("mlp", None), fsdp_dim=1),
    }


def rwkv_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    d = cfg.d_model
    h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {
        "state": ParamInfo((batch, h, dh, dh), "float32",
                           ("batch", "heads", None, None)),
        "x_att": ParamInfo((batch, d), cfg.dtype, ("batch", None)),
        "x_ffn": ParamInfo((batch, d), cfg.dtype, ("batch", None)),
    }


def _shift(x, prev=None):
    """x_{t-1} along the sequence; ``prev`` fills t = 0 (decode carries
    it), zeros without one."""
    if prev is None:
        if is_dtensor(x):
            # Each device shifts its own rows: torch 2.11's DTensor pads on
            # a 1-D mesh only (its ``constant_pad_nd`` strategy).
            rows = ("batch", None, None)
            return local_by_axes(_shift, (x,), [rows], [(rows, x.shape)])
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _head_norm(cfg: ModelConfig, p, x):
    """Per-head RMS norm with learned scale (GroupNorm analogue), in f32."""
    b, s, h, d = x.shape
    x32 = x.float()
    y = x32 * torch.rsqrt(
        torch.mean(torch.square(x32), dim=-1, keepdim=True) + 1e-5)
    return y.reshape(b, s, h * d) * (1.0 + p["ln_x"].float())


def rwkv_time_mix(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None):
    """Time-mix over a full sequence x [B,S,d] -> [B,S,d]; with ``cache``
    (state, x_att) one token a slot -> (y, {state, x_att})."""
    dt = adtype(cfg)
    b, s, d = x.shape
    if cache is None and s % _CHUNK:
        raise ValueError(f"seq {s} not divisible by chunk {_CHUNK} (the "
                         f"reference's chunked recurrence needs it)")
    h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    xs = _shift(x, None if cache is None else cache["x_att"])
    mu = p["mu"].to(dt)
    xr, xk, xv, xw, xg = (_mix(x, xs, mu[i]) for i in range(5))

    r = (xr @ p["wr"].to(dt)).reshape(b, s, h, dh)
    k = (xk @ p["wk"].to(dt)).reshape(b, s, h, dh)
    v = (xv @ p["wv"].to(dt)).reshape(b, s, h, dh)
    g = F.silu(xg @ p["wg"].to(dt))
    # Data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B)).
    lora = torch.tanh(xw @ p["wA"].to(dt)) @ p["wB"].to(dt)
    logw = -torch.exp(torch.clamp(p["w0"].float() + lora.float(), -8.0, 4.0))
    logw = logw.reshape(b, s, h, dh)

    if cache is None:
        out = ops.rwkv_mix(r, k, v, logw, p["u"])
    else:
        state = cache["state"]                                 # [B,H,D,D]
        args = (r[:, 0], k[:, 0], v[:, 0], logw[:, 0], state, p["u"])
        if is_dtensor(state):   # under a mesh: each device its rows, heads
            row = ("batch", "heads", None)
            out, state = local_by_axes(
                _decode_step, args, [row] * 4 + [row + (None,),
                                                 ("heads", None)],
                [(("batch", None, "heads", None), (b, 1, h, dh)),
                 (row + (None,), state.shape)])
        else:
            out, state = _decode_step(*args)
    y = _head_norm(cfg, p, out).to(dt) * g
    y = shard(y @ p["wout"].to(dt), "batch", None, "embed")
    if cache is None:
        return y
    return y, {"state": state, "x_att": x[:, -1]}


def _decode_step(r, k, v, logw, state, u):
    """One token of the recurrence: r, k, v, logw [B,H,D], state [B,H,D,D]
    f32, u [H,D] -> (out [B,1,H,D], the new state)."""
    r1, k1, v1 = r.float(), k.float(), v.float()
    kv = k1[..., :, None] * v1[..., None, :]                   # kᵀv
    bonus = state + u.float()[None, :, :, None] * kv
    out = torch.einsum("bhd,bhde->bhe", r1, bonus)[:, None]
    return out, state * torch.exp(logw)[..., None] + kv


def rwkv_channel_mix(cfg: ModelConfig, p, x, *,
                     cache: Optional[dict] = None):
    """Channel-mix (squared-ReLU FFN with a sigmoid receptance gate); with
    ``cache`` (x_ffn) -> (y, {x_ffn})."""
    dt = adtype(cfg)
    xs = _shift(x, None if cache is None else cache["x_ffn"])
    mu = p["mu_c"].to(dt)
    xk, xr = _mix(x, xs, mu[0]), _mix(x, xs, mu[1])
    r = torch.sigmoid(rows_matmul(xr, p["wr_c"].to(dt)))
    k = shard(torch.square(torch.relu(xk @ p["wk_c"].to(dt))), "batch", None,
              "mlp")
    # The product's partial sums over the mesh's mlp shards are reduced
    # before the gate (no-op without a mesh): DTensor's backward through a
    # gate on a partial sum scatters its gradient over batch and sequence
    # at once, which the gate's own matrix product cannot take.
    # The gated output keeps the receptance's rows (its sequence slice
    # under a mesh: the residual stream's layout).
    kv = shard(k @ p["wv_c"].to(dt), "batch", None, "embed")
    y = shard(r * kv, "batch", "seq", "embed")
    return y if cache is None else (y, {"x_ffn": x[:, -1]})
