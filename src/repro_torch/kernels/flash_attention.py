"""Flash attention: the wrapper over the hand-written Hopper kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: online-softmax attention
with GQA, bottom-right causal masking and an optional sliding window, plus a
per-row ``kv_len`` for per-slot decode.  A tensor on the CPU goes to the
plain version (``ref.flash_reference``); a CUDA tensor launches the kernel
or raises.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import flash_reference

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, kv_len, out; B, Hq, Hkv, Sq, Skv, D, dtype, causal, window; stream
_SIGNATURES = {"flash_attention_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    ctypes.c_int)}


def _check(q, k, v, kv_len, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Hq,Sq,D] and k/v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not form a GQA attention")
    if min(b, sq, skv) == 0:
        raise ValueError("empty attention")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if causal and kv_len is None and sq > skv:
        raise ValueError(f"causal attention with Sq={sq} > Skv={skv} leaves "
                         f"rows with no visible key")
    if kv_len is not None and (kv_len.shape != (b,)
                               or kv_len.dtype != torch.int32):
        raise ValueError(f"kv_len must be int32 [{b}], got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel yet; "
                           "call it under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D]."""
    _check(q, k, v, kv_len, causal, window)
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_reference(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"q/k/v/kv_len must all lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous q/k/v/kv_len")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d, _DTYPES[q.dtype], int(causal),
            int(window), stream)
    _build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
