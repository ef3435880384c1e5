"""RWKV6 WKV recurrence: the wrappers over the hand-written Hopper kernels.

The kernels replace the Pallas TPU kernel
``repro.kernels.rwkv6_chunk.rwkv6_chunk``: the same function, per b*h a
recurrence over a ``[D,D]`` f32 state with per-channel decay ``exp(w_log)``
and bonus ``u``, for any S >= 1, finite for every decay the model makes (the
Pallas kernel's ``exp(-cum)`` factor overflows there).  The backward is a
kernel too; the JAX package has none (its training differentiates the
model's ``_chunked_wkv`` through XLA).  Two variants, chosen by :func:`plan`
from dtype, shape and alignment alone:

- ``mma`` (``csrc/rwkv6_chunked.cu``), bf16 r/k/v: the model's chunked form
  (16-step chunks, pairwise log-space decay inside a chunk) made parallel
  over time: spans of several chunks get their local states in one pass, a
  scan over spans gives each its start state (and, backward, its end
  adjoint), and a block per (b*h, span) walks its chunks with the products
  on the tensor cores (``mma.sync``, TF32 operands, f32 sums).
- ``simt`` (``csrc/rwkv6.cu``), f32 and bf16 inputs the ``mma`` variant does
  not take: the serial scan, a block per b*h.

``rwkv6_chunk`` is what the model calls: on CPU tensors the plain version
(``ref.rwkv6_reference``, differentiated by autograd), on CUDA tensors a
``torch.autograd.Function`` whose forward launches ``rwkv6_fwd`` and whose
backward launches ``rwkv6_bwd``.  Each wrapper counts its launches in
``.launches`` and per variant in ``.variant_launches``.  The launches are
dispatcher ops (``repro_torch::rwkv6_fwd``, ``::rwkv6_bwd``) with fake
implementations, which the dry run traces.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rwkv6_backward_reference, rwkv6_reference

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("simt", "mma")
CHUNK = 16       # steps a chunk: the JAX model's _CHUNK, mma's M
SPAN_FWD = 128   # steps a span, forward: 8 chunks
SPAN_BWD = 64    # backward: 4 chunks, whose start states fit shared memory
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
_MMA_SIGNATURES = {
    # r, k, v, logw, u, out, scratch; BH, S, D, span; stream
    "rwkv6_mma_fwd": ([_P] * 7 + [_I] * 4 + [_P], _I),
    # r, k, v, logw, u, g, gr, gk, gv, glogw, gu, scratch; BH, S, D, span;
    # stream
    "rwkv6_mma_bwd": ([_P] * 12 + [_I] * 4 + [_P], _I),
}


def plan(bh: int, s: int, d: int, dtype: torch.dtype,
         aligned: bool = True) -> dict:
    """The kernel variant for one call, from its shape alone.

    bf16 r/k/v with 16-byte-aligned bases (``aligned``: the chunks are
    staged with 16-byte ``cp.async`` copies) go to ``mma``: a block per
    (b*h, span of ``span_fwd`` or ``span_bwd`` steps), and f32 scratch of
    ``scratch_fwd`` / ``scratch_bwd`` floats for the spans' states (and
    adjoints) and total decays.  f32 inputs, whose products the tensor
    cores would round to TF32, and unaligned ones go to ``simt``, a block
    per b*h.  Head dims other than 32 and 64 are refused.
    """
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernels take {HEAD_DIMS}")
    if dtype == torch.bfloat16 and aligned:
        nf, nb = -(-s // SPAN_FWD), -(-s // SPAN_BWD)
        return {"variant": "mma", "span_fwd": SPAN_FWD,
                "span_bwd": SPAN_BWD, "blocks_fwd": bh * nf,
                "blocks_bwd": bh * nb, "scratch_fwd": bh * nf * (d * d + d),
                "scratch_bwd": 2 * bh * nb * (d * d + d)}
    return {"variant": "simt", "blocks_fwd": bh, "blocks_bwd": bh}


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
    if not _build.sharded(tensors[0]) and (
            dev.type != "cuda" or any(t.device != dev for t in tensors)):
        raise ValueError(f"{what}: all tensors must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")
    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d}; the kernel takes "
                         f"{HEAD_DIMS}")


def _plan_for(tensors) -> dict:
    r = tensors[0]
    return plan(*r.shape, r.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in tensors))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def rwkv6_fwd(r, k, v, w_log, u) -> torch.Tensor:
    """The forward kernel: r, k, v [BH,S,D] (f32 or bf16), w_log [BH,S,D]
    and u [BH,D] f32 -> out [BH,S,D] f32.  CPU tensors go to the plain
    version."""
    _check(r, k, v, w_log, u)
    if _build.plain((r, k, v, w_log, u)):
        return rwkv6_reference(r, k, v, w_log, u)
    _on_card((r, k, v, w_log, u), "rwkv6_fwd")
    return torch.ops.repro_torch.rwkv6_fwd(r, k, v, w_log, u)


@torch.library.custom_op("repro_torch::rwkv6_fwd", mutates_args=())
def _launch_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_log: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The forward launch, as a dispatcher op so that fake tensors (the
    dry run's) and DTensors reach it."""
    bh, s, d = r.shape
    out = torch.empty((bh, s, d), dtype=torch.float32, device=r.device)
    p = _plan_for((r, k, v, w_log, u, out))
    with torch.cuda.device(r.device):
        if p["variant"] == "mma":
            lib = _build.load("rwkv6_chunked", _MMA_SIGNATURES)
            scratch = torch.empty(p["scratch_fwd"], dtype=torch.float32,
                                  device=r.device)
            err = lib.rwkv6_mma_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                u.data_ptr(), out.data_ptr(), scratch.data_ptr(), bh, s, d,
                p["span_fwd"], _stream(r))
        else:
            lib = _build.load("rwkv6", _SIGNATURES)
            err = lib.rwkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w_log.data_ptr(), u.data_ptr(),
                                out.data_ptr(), bh, s, d, _DTYPES[r.dtype],
                                _stream(r))
    _build.check(lib, err, f"rwkv6_fwd launch ({p['variant']})")
    rwkv6_fwd.launches += 1
    rwkv6_fwd.variant_launches[p["variant"]] += 1
    return out


@_launch_fwd.register_fake
def _(r, k, v, w_log, u):
    return r.new_empty(r.shape, dtype=torch.float32)


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
    if _build.plain(tensors):
        return rwkv6_backward_reference(r, k, v, w_log, u, g)
    _on_card(tensors, "rwkv6_bwd")
    return torch.ops.repro_torch.rwkv6_bwd(r, k, v, w_log, u, g)


@torch.library.custom_op("repro_torch::rwkv6_bwd", mutates_args=())
def _launch_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_log: torch.Tensor, u: torch.Tensor, g: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """The backward launch, as a dispatcher op (see ``_launch_fwd``)."""
    tensors = (r, k, v, w_log, u, g)
    bh, s, d = r.shape
    gr, gk, gv = (torch.empty_like(r) for _ in range(3))
    gw = torch.empty_like(w_log)
    gu = torch.empty_like(u)
    p = _plan_for(tensors + (gr, gk, gv, gw, gu))
    with torch.cuda.device(r.device):
        if p["variant"] == "mma":
            lib = _build.load("rwkv6_chunked", _MMA_SIGNATURES)
            scratch = torch.empty(p["scratch_bwd"], dtype=torch.float32,
                                  device=r.device)
            err = lib.rwkv6_mma_bwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                u.data_ptr(), g.data_ptr(), gr.data_ptr(), gk.data_ptr(),
                gv.data_ptr(), gw.data_ptr(), gu.data_ptr(),
                scratch.data_ptr(), bh, s, d, p["span_bwd"], _stream(r))
        else:
            lib = _build.load("rwkv6", _SIGNATURES)
            ckpt = torch.empty(lib.rwkv6_bwd_ckpt_floats(bh, s, d),
                               dtype=torch.float32, device=r.device)
            err = lib.rwkv6_bwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                u.data_ptr(), g.data_ptr(), gr.data_ptr(), gk.data_ptr(),
                gv.data_ptr(), gw.data_ptr(), gu.data_ptr(), ckpt.data_ptr(),
                bh, s, d, _DTYPES[r.dtype], _stream(r))
    _build.check(lib, err, f"rwkv6_bwd launch ({p['variant']})")
    rwkv6_bwd.launches += 1
    rwkv6_bwd.variant_launches[p["variant"]] += 1
    return gr, gk, gv, gw, gu


@_launch_bwd.register_fake
def _(r, k, v, w_log, u, g):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w_log), torch.empty_like(u))


rwkv6_fwd.launches = 0
rwkv6_bwd.launches = 0
rwkv6_fwd.variant_launches = dict.fromkeys(VARIANTS, 0)
rwkv6_bwd.variant_launches = dict.fromkeys(VARIANTS, 0)


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
    if _build.plain((r, k, v, w_log, u)):
        return rwkv6_reference(r, k, v, w_log, u)
    _on_card((r, k, v, w_log, u), "rwkv6_chunk")
    return _WKV6.apply(r, k, v, w_log, u)
