"""RWKV6 WKV recurrence: the wrappers over the hand-written Hopper kernels.

The kernels (``csrc/rwkv6.cu``) replace the Pallas TPU kernel
``repro.kernels.rwkv6_chunk.rwkv6_chunk``: the same function, per b*h a
serial recurrence over a ``[D,D]`` f32 state with per-channel decay
``exp(w_log)`` and bonus ``u``, computed step by step rather than in the
Pallas kernel's chunked form (whose ``exp(-cum)`` factor overflows for
decays the model makes), so any S >= 1 is taken.  The backward is a kernel
too; the JAX package has none (its training differentiates the model's
``_chunked_wkv`` through XLA).

``rwkv6_chunk`` is what the model calls: on CPU tensors the plain version
(``ref.rwkv6_reference``, differentiated by autograd), on CUDA tensors a
``torch.autograd.Function`` whose forward launches ``rwkv6_fwd`` and whose
backward launches ``rwkv6_bwd``.  ``rwkv6_fwd.launches`` and
``rwkv6_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rwkv6_backward_reference, rwkv6_reference

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # r, k, v, logw, u, out; BH, S, D, dtype; stream
    "rwkv6_fwd": ([_P] * 6 + [_I] * 4 + [_P], _I),
    # r, k, v, logw, u, g, gr, gk, gv, glogw, gu, ckpt; BH, S, D, dtype;
    # stream
    "rwkv6_bwd": ([_P] * 12 + [_I] * 4 + [_P], _I),
    "rwkv6_bwd_ckpt_floats": ([_I] * 3, ctypes.c_longlong),
}


def _check(r, k, v, w_log, u):
    if r.dim() != 3 or k.shape != r.shape or v.shape != r.shape \
            or w_log.shape != r.shape:
        raise ValueError(f"want r, k, v, w_log [BH,S,D] of one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w_log)]}")
    bh, s, d = r.shape
    if u.shape != (bh, d):
        raise ValueError(f"want u [{bh},{d}], got {tuple(u.shape)}")
    if bh == 0 or s == 0:
        raise ValueError("empty recurrence")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"want float32 or bfloat16 r/k/v of one dtype, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w_log.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"want float32 w_log and u, got {w_log.dtype}, "
                        f"{u.dtype}")


def _on_card(tensors, what: str):
    """Raise unless every tensor is a contiguous tensor on one CUDA device
    and the head dim is one the kernels take."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all tensors must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")
    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d}; the kernel takes "
                         f"{HEAD_DIMS}")


def rwkv6_fwd(r, k, v, w_log, u) -> torch.Tensor:
    """The forward kernel: r, k, v [BH,S,D] (f32 or bf16), w_log [BH,S,D]
    and u [BH,D] f32 -> out [BH,S,D] f32.  CPU tensors go to the plain
    version."""
    _check(r, k, v, w_log, u)
    if all(t.device.type == "cpu" for t in (r, k, v, w_log, u)):
        return rwkv6_reference(r, k, v, w_log, u)
    _on_card((r, k, v, w_log, u), "rwkv6_fwd")
    bh, s, d = r.shape
    lib = _build.load("rwkv6", _SIGNATURES)
    out = torch.empty((bh, s, d), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w_log.data_ptr(), u.data_ptr(), out.data_ptr(),
                            bh, s, d, _DTYPES[r.dtype], stream)
    _build.check(lib, err, "rwkv6_fwd launch")
    rwkv6_fwd.launches += 1
    return out


def rwkv6_bwd(r, k, v, w_log, u, g):
    """The backward kernel: the forward's inputs and the output gradient
    ``g`` (f32 [BH,S,D]) -> ``(gr, gk, gv, gw_log, gu)``, gr/gk/gv in r's
    dtype (rounded once), gw_log [BH,S,D] and gu [BH,D] f32.  CPU tensors go
    to the plain version (autograd through ``rwkv6_reference``)."""
    _check(r, k, v, w_log, u)
    if g.shape != r.shape or g.dtype != torch.float32:
        raise ValueError(f"want g f32 {tuple(r.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    tensors = (r, k, v, w_log, u, g)
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_backward_reference(r, k, v, w_log, u, g)
    _on_card(tensors, "rwkv6_bwd")
    bh, s, d = r.shape
    lib = _build.load("rwkv6", _SIGNATURES)
    gr, gk, gv = (torch.empty_like(r) for _ in range(3))
    gw = torch.empty_like(w_log)
    gu = torch.empty_like(u)
    ckpt = torch.empty(lib.rwkv6_bwd_ckpt_floats(bh, s, d),
                       dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), g.data_ptr(), gr.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), gw.data_ptr(), gu.data_ptr(), ckpt.data_ptr(),
            bh, s, d, _DTYPES[r.dtype], stream)
    _build.check(lib, err, "rwkv6_bwd launch")
    rwkv6_bwd.launches += 1
    return gr, gk, gv, gw, gu


rwkv6_fwd.launches = 0
rwkv6_bwd.launches = 0


class _WKV6(torch.autograd.Function):
    """The recurrence on the card: a kernel each way."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u):
        ctx.save_for_backward(r, k, v, w_log, u)
        return rwkv6_fwd(r, k, v, w_log, u)

    @staticmethod
    def backward(ctx, g):
        return rwkv6_bwd(*ctx.saved_tensors, g.contiguous())


def rwkv6_chunk(r, k, v, w_log, u) -> torch.Tensor:
    """r, k, v, w_log: [BH, S, D]; u: [BH, D].  Returns [BH, S, D] (f32),
    differentiable in every input."""
    _check(r, k, v, w_log, u)
    if all(t.device.type == "cpu" for t in (r, k, v, w_log, u)):
        return rwkv6_reference(r, k, v, w_log, u)
    _on_card((r, k, v, w_log, u), "rwkv6_chunk")
    return _WKV6.apply(r, k, v, w_log, u)
