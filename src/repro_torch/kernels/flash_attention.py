"""Flash attention: the wrapper over the hand-written Hopper kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: online-softmax attention
with GQA, bottom-right causal masking and an optional sliding window, plus a
per-row ``kv_len`` for per-slot decode.  A tensor on the CPU goes to the
plain version (``ref.flash_reference``); a CUDA tensor launches the kernel
variant that :func:`plan` names, or raises.  ``flash_attention.launches``
counts kernel launches, ``flash_attention.variant_launches`` the launches of
each variant.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_reference

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1}
WGMMA_HEAD_DIMS = (32, 64, 128)
SMS = 132              # H100 SXM
MAX_SPLITS = 8
MAX_GRID_Y = 65535
# q, k, v, kv_len, out; B, Hq, Hkv, Sq, Skv, D, dtype, causal, window,
# variant, splits; part_o, part_ml, tickets, stream
_SIGNATURES = {"flash_attention_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 4,
    ctypes.c_int)}
# Per (device, stream): int32 tickets of the split-kv combine, zero between
# launches (the combining block resets its own).  Launches on one stream run
# in order, so they never share a ticket while both are in flight.
_TICKETS: dict = {}


def plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
         dtype: torch.dtype, aligned: bool = True) -> dict:
    """The kernel variant, tiles and kv splits for one call, from its shape.

    bf16 with D in (32, 64, 128) and 16-byte-aligned bases goes to
    ``wgmma``: blocks of 64 query rows (a whole GQA group at decode) over
    64-key K/V tiles, the row tiles on the grid's y axis (at most
    ``MAX_GRID_Y``).  When the grid of B * Hkv * row_tiles blocks is at
    most a quarter of the card's SMs and the keys span several tiles, the
    key range is split over up to ``MAX_SPLITS`` blocks.  The rest (f32,
    whose products the tensor cores would round to TF32, other head dims,
    longer query ranges) goes to ``simt``: 8 rows a block, 32-key tiles.
    """
    rows = (hq // hkv) * sq
    row_tiles = -(-rows // 64)
    if (dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and aligned
            and row_tiles <= MAX_GRID_Y):
        blocks = b * hkv * row_tiles
        kv_tiles = -(-skv // 64)
        splits = 1
        if 4 * blocks <= SMS and kv_tiles > 1:
            splits = min(kv_tiles, SMS // blocks, MAX_SPLITS)
        return {"variant": "wgmma", "block_q": 64, "block_kv": 64,
                "row_tiles": row_tiles, "kv_splits": splits}
    return {"variant": "simt", "block_q": 8, "block_kv": 32,
            "row_tiles": -(-rows // 8), "kv_splits": 1}


def _tickets(device, stream, n):
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return t


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
    out = torch.empty_like(q)
    p = plan(b, hq, hkv, sq, skv, d, q.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = [None, None, None]
    if p["kv_splits"] > 1:
        # f32 partials per (b, kv head, row tile, split, row): the output
        # row (head dim padded to 64s), then (max, sum).
        slots = b * hkv * p["row_tiles"] * p["kv_splits"] * p["block_q"]
        part_o = torch.empty(slots * 64 * math.ceil(d / 64),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty(slots * 2, dtype=torch.float32,
                              device=q.device)
        tickets = _tickets(q.device, stream, b * hkv * p["row_tiles"])
        scratch = [t.data_ptr() for t in (part_o, part_ml, tickets)]
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d, _DTYPES[q.dtype], int(causal),
            int(window), VARIANTS[p["variant"]], p["kv_splits"], *scratch,
            stream)
    _build.check(lib, err, f"flash_attention launch ({p['variant']})")
    flash_attention.launches += 1
    flash_attention.variant_launches[p["variant"]] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
