"""Flash attention: the wrapper over the hand-written Hopper kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: online-softmax attention
with GQA, bottom-right causal masking and an optional sliding window, plus a
per-row ``kv_len`` for per-slot decode, and an optional attention-logit
soft cap (``softcap`` c > 0: each scaled logit s becomes c tanh(s / c)
before the mask and the softmax, the JAX model's ``logit_softcap``).  A tensor on the CPU goes to the
plain version (``ref.flash_reference``, blocked over queries from
``ref.BLOCKED_ATTN_THRESHOLD`` rows on as the JAX model's attention is,
differentiated by autograd); a CUDA tensor launches the kernel variant that
:func:`plan` names, or raises.
Where q, k or v requires grad, the call on the card is a
``torch.autograd.Function``: its forward also writes each row's log-sum-exp
and saves q, k, v, the output and the LSE; its backward launches
:func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cu``; the JAX package
has no backward kernel, it differentiates its attention through XLA), whose
variant and tiles :func:`plan_backward` chooses.  ``.launches`` counts each
wrapper's kernel launches, ``.variant_launches`` those of each variant.
Each launch is a dispatcher op (``repro_torch::flash_fwd``, ``::flash_bwd``)
with a fake implementation, so that fake tensors and DTensors (the dry
run, ``launch/dryrun.py``) reach the entry points the card runs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import (BLOCKED_ATTN_THRESHOLD, flash_backward_reference,
                  flash_reference, flash_reference_blocked)

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "wgmma": 1}
WGMMA_HEAD_DIMS = (32, 64, 128, 256)
SMS = 132              # H100 SXM
MAX_SPLITS = 8
MAX_GRID_Y = 65535
BWD_MAX_HEAD_DIM = 256
BWD_VARIANTS = {"simt": 0, "mma": 1, "wgmma": 2}
# Head dims the ``wgmma`` backward takes (bf16): one warpgroup a tile block
# at 64, two at 128 and 256, which split the head columns.
BWD_WGMMA_HEAD_DIMS = (64, 128, 256)
# (block, step) of each backward variant: keys of a dK/dV block and rows of
# a dQ block; queries of a dK/dV step and keys of a dQ step.
BWD_TILES = {"simt": (32, 32), "mma": (64, 32), "wgmma": (64, 64)}
# q, k, v, kv_len, out, lse; B, Hq, Hkv, Sq, Skv, D, dtype, causal, window,
# variant, splits, block_q; softcap; part_o, part_ml, tickets, stream
_SIGNATURES = {"flash_attention_fwd": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_float]
    + [ctypes.c_void_p] * 4, ctypes.c_int)}
# q, k, v, o, lse, dout, dq, dk, dv, scratch; scratch_floats; B, Hq, Hkv,
# Sq, Skv, D, dtype, causal, window, variant, block, step, dp; softcap;
# stream
_BWD_SIGNATURES = {"flash_attention_bwd": (
    [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 13
    + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)}
# Per (device, stream): int32 tickets of the split-kv combine, zero between
# launches (the combining block resets its own).  Launches on one stream run
# in order, so they never share a ticket while both are in flight.
_TICKETS: dict = {}


def plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
         dtype: torch.dtype, aligned: bool = True,
         save_lse: bool = False) -> dict:
    """The kernel variant, tiles and kv splits for one call, from its shape.

    bf16 with D in (32, 64, 128, 256) and 16-byte-aligned bases goes to
    ``wgmma``: blocks of 64 query rows (a whole GQA group at decode), one
    consumer warpgroup each, over 64-key K/V tiles, the row tiles on the
    grid's y axis (at most ``MAX_GRID_Y``).  At D 256 a block of more than
    64 rows' work (gemma3-1b's and recurrentgemma-2b's train and prefill
    calls) holds 128 rows, two consumer warpgroups sharing each K/V tile;
    their decode (G * Sq <= 64 rows: 4 and 10) keeps the 64-row block.
    When the grid of B * Hkv * row_tiles blocks is at most a quarter of the
    card's SMs and the keys span several tiles, the key range is split over
    up to ``MAX_SPLITS`` blocks.  The rest (f32, whose products the tensor
    cores would round to TF32, other head dims, longer query ranges) goes to
    ``simt``: 8 rows a block, 32-key tiles.  A call that saves the LSE for
    the backward (``save_lse``) never splits.
    """
    rows = (hq // hkv) * sq
    block_q = 128 if d == 256 and rows > 64 else 64
    row_tiles = -(-rows // block_q)
    if (dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and aligned
            and row_tiles <= MAX_GRID_Y):
        blocks = b * hkv * row_tiles
        kv_tiles = -(-skv // 64)
        splits = 1
        if 4 * blocks <= SMS and kv_tiles > 1 and not save_lse:
            splits = min(kv_tiles, SMS // blocks, MAX_SPLITS)
        return {"variant": "wgmma", "block_q": block_q, "block_kv": 64,
                "row_tiles": row_tiles, "kv_splits": splits}
    return {"variant": "simt", "block_q": 8, "block_kv": 32,
            "row_tiles": -(-rows // 8), "kv_splits": 1}


def bwd_query_range(j0: int, n_keys: int, sq: int, skv: int, causal: bool,
                    window: int) -> tuple[int, int]:
    """Query rows ``[lo, hi)`` that see any of keys ``[j0, j0 + n_keys)``
    (query i sits at key position ``i + skv - sq``); the dK/dV kernel walks
    its query tiles from ``lo`` in steps of the plan's ``dkdv_step``."""
    offs = skv - sq
    lo, hi = 0, sq
    if causal:
        lo = max(0, j0 - offs)
        if window > 0:
            hi = min(sq, j0 + n_keys - 1 + window - offs)
    return lo, hi


def bwd_key_range(i0: int, n_rows: int, sq: int, skv: int, causal: bool,
                  window: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` that any of query rows ``[i0, i0 + n_rows)`` sees;
    the dQ kernel walks its key tiles from ``lo`` in steps of the plan's
    ``dq_step``."""
    offs = skv - sq
    lo, hi = 0, skv
    if causal:
        hi = min(skv, i0 + n_rows + offs)
        if window > 0:
            lo = max(0, i0 + offs - window + 1)
    return lo, hi


def plan_backward(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                  dtype: torch.dtype) -> dict:
    """The backward kernels' variant, tiles and grids for one call.

    bf16 with D 64 (qwen2, llama3.2-1b, smollm-135m), 128 (mixtral) or 256
    (gemma3-1b, recurrentgemma-2b) goes to ``wgmma``: tensor cores through
    ``wgmma``, tiles brought by TMA, and the dK/dV work split over the G
    query heads of each kv head.  The rest (f32, whose products the tensor
    cores would round to TF32, and other head dims) goes to ``simt``.
    ``mma``, the design before ``wgmma`` at D 64, and ``simt`` for bf16
    are reached through :func:`backward_schedule`.
    """
    if d % 8 or d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the backward kernel takes multiples "
                         f"of 8 up to {BWD_MAX_HEAD_DIM}")
    variant = ("wgmma" if dtype == torch.bfloat16
               and d in BWD_WGMMA_HEAD_DIMS else "simt")
    return backward_schedule(variant, b, hq, hkv, sq, skv, d)


def backward_schedule(variant: str, b: int, hq: int, hkv: int, sq: int,
                      skv: int, d: int) -> dict:
    """``variant``'s tiles, grids and scratch for one backward call.

    Every variant first takes ``D = rowsum(dO * O)`` per query row, then
    runs a dK/dV pass over ``block``-key tiles, each block walking the
    query tiles of :func:`bwd_query_range` in steps of ``step``, and a dQ
    pass over ``block``-row query tiles walking the key tiles of
    :func:`bwd_key_range` in steps of ``step``.

    - ``simt`` and ``mma`` (``split_heads`` False): one dK/dV block per
      (key tile, b, kv head) walks all G query heads of its kv head;
      ``grid_dkdv`` is (key tiles, b * hkv), ``grid_dq`` (query tiles,
      b * hq); the walks start at the range's first row (key).
    - ``wgmma`` (``split_heads`` True): one dK/dV block per (b, q head, key
      tile), the tile on the grid's slow axis (heaviest causal tiles
      first); each writes its head's f32 partial dK and dV, and a reduce
      pass (``grid_reduce`` blocks of 128 threads, four columns a thread)
      sums the G heads of a kv head in head order.  ``grid_dkdv`` is
      (b * hq, key tiles) and ``grid_dq`` (b * hq, query tiles); the walks
      start at the multiple of ``step`` at or below the range's first row
      (key), and the row statistics are padded to ``sq_pad`` rows.  A tile
      block is ``warpgroups`` warpgroups: one at ``dp`` 64; two at 128 and
      256, which split S^T and dP^T (S and dP) by their 64 query (key)
      columns, 32 each, and dK, dV (dQ) by their head columns, ``dp / 2``
      each.  The partials hold ``dp`` columns a key.

    The tiles are each variant's ``BWD_TILES``, compiled into the kernels,
    which refuse a launch whose ``block``, ``step``, ``dp`` or
    ``scratch_floats`` differs from their own.
    """
    block, step = BWD_TILES[variant]
    kv_tiles, q_tiles = -(-skv // block), -(-sq // block)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    s = {"variant": variant, "block": block, "step": step, "dp": dp,
         "split_heads": variant == "wgmma"}
    if variant == "wgmma":
        sq_pad = q_tiles * block
        s.update(grid_dkdv=(b * hq, kv_tiles), grid_dq=(b * hq, q_tiles),
                 warpgroups=1 if dp == 64 else 2,
                 grid_reduce=-(-b * hkv * skv * dp // (4 * 128)),
                 sq_pad=sq_pad,
                 scratch_floats=2 * b * hq * sq_pad + 2 * b * hq * skv * dp)
    else:
        s.update(grid_dkdv=(kv_tiles, b * hkv), grid_dq=(q_tiles, b * hq),
                 scratch_floats=b * hq * sq)
    return s


def _tickets(device, stream, n):
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return t


def _check(q, k, v, kv_len, causal, window, softcap=0.0):
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
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if causal and kv_len is None and sq > skv:
        raise ValueError(f"causal attention with Sq={sq} > Skv={skv} leaves "
                         f"rows with no visible key")
    if kv_len is not None and (kv_len.shape != (b,)
                               or kv_len.dtype != torch.int32):
        raise ValueError(f"kv_len must be int32 [{b}], got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    Differentiable in q, k and v (not with ``kv_len``, which only decode
    passes).  ``softcap`` > 0 caps each scaled logit s at
    ``softcap * tanh(s / softcap)``."""
    softcap = float(softcap)
    _check(q, k, v, kv_len, causal, window, softcap)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if grad and kv_len is not None:
        raise ValueError("flash_attention: no backward with kv_len (decode "
                         "only); call it under torch.no_grad()")
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    if _build.plain(tensors):
        cap = {"softcap": softcap} if softcap else {}
        if kv_len is None and q.shape[2] >= BLOCKED_ATTN_THRESHOLD:
            return flash_reference_blocked(q, k, v, causal=causal,
                                           window=window, **cap)
        return flash_reference(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, **cap)
    if grad:
        return _Flash.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, kv_len, save_lse=False,
                    softcap=softcap)[0]


def _forward(q, k, v, causal, window, kv_len, save_lse, softcap=0.0):
    """Launch the forward kernel; returns ``(out, lse)`` (lse None unless
    ``save_lse``)."""
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    if not _build.sharded(q) and (any(t.device != q.device for t in tensors)
                                  or q.device.type != "cuda"):
        raise ValueError(f"q/k/v/kv_len must all lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous q/k/v/kv_len")
    out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, kv_len, causal,
                                               window, softcap, save_lse)
    return out, (lse if save_lse else None)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: Optional[torch.Tensor], causal: bool, window: int,
                softcap: float, save_lse: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward launch, as a dispatcher op so that fake tensors (the
    dry run's) and DTensors reach it: ``(out, lse)``, lse empty unless
    ``save_lse``."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    p = plan(b, hq, hkv, sq, skv, d, q.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out)), save_lse=save_lse)
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
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, sq, skv, d, _DTYPES[q.dtype], int(causal),
            int(window), VARIANTS[p["variant"]], p["kv_splits"],
            p["block_q"], softcap, *scratch, stream)
    _build.check(lib, err, f"flash_attention launch ({p['variant']})")
    flash_attention.launches += 1
    flash_attention.variant_launches[p["variant"]] += 1
    return out, lse if save_lse else out.new_empty(0, dtype=torch.float32)


@_launch_fwd.register_fake
def _(q, k, v, kv_len, causal, window, softcap, save_lse):
    return (torch.empty_like(q), q.new_empty(
        q.shape[:3] if save_lse else (0,), dtype=torch.float32))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The backward kernels: the forward's inputs, its output ``o`` and row
    log-sum-exp ``lse`` (f32 [B,Hq,Sq], of the capped logits where
    ``softcap`` > 0) and the output gradient ``do`` -> ``(dq, dk, dv)`` in
    the inputs' dtype.  CPU tensors go to the plain version
    (``ref.flash_backward_reference``)."""
    softcap = float(softcap)
    _check(q, k, v, None, causal, window, softcap)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"want o and do {q.dtype} {tuple(q.shape)}, got "
                         f"{o.dtype} {tuple(o.shape)}, {do.dtype} "
                         f"{tuple(do.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"want lse f32 {(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    tensors = (q, k, v, o, lse, do)
    if _build.plain(tensors):
        return flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        window=window, softcap=softcap)
    if not _build.sharded(q) and (q.device.type != "cuda" or any(
            t.device != q.device for t in tensors)):
        raise ValueError(f"flash_attention_bwd: all tensors must lie on one "
                         f"CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_bwd: the kernels take contiguous "
                         "tensors")
    return torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do, causal,
                                           window, softcap)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                causal: bool, window: int, softcap: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launches, as a dispatcher op (see ``_launch_fwd``)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    tensors = (q, k, v, o, lse, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = tensors + (dq, dk, dv)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ptrs):
        raise ValueError("flash_attention_bwd: the kernels take contiguous, "
                         "16-byte-aligned tensors")
    p = plan_backward(b, hq, hkv, sq, skv, d, q.dtype)
    scratch = torch.empty(p["scratch_floats"], dtype=torch.float32,
                          device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            *(t.data_ptr() for t in ptrs[:6]), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), p["scratch_floats"], b, hq,
            hkv, sq, skv, d,
            _DTYPES[q.dtype], int(causal), int(window),
            BWD_VARIANTS[p["variant"]], p["block"], p["step"], p["dp"],
            softcap, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"flash_attention_bwd launch ({p['variant']})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[p["variant"]] += 1
    return dq, dk, dv


@_launch_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _Flash(torch.autograd.Function):
    """Attention on the card: the forward kernel (saving the LSE), and the
    backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap=0.0):
        out, lse = _forward(q, k, v, causal, window, None, save_lse=True,
                            softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
